"""The sampler and poly_echo configs (port of zang_tpu/host/configs.py).

- sampler: drum-loop playback * 2.5 -> overdrive -> decimator
  (example_sampler.zig plus the Decimator of example_polyphony.zig).
  A tiled chunk is one launch of the sampler kernel (ops/sampler.py
  sampler_play); a flat one's taps go through the two-tap lookup.
- poly_echo: N NiceInstrument voices -> mono mix / N -> StereoEchoes
  (example_polyphony2.zig and example_delay.zig's StereoEchoes(15000)).
  The voices' lowpass is the table-cut SVF kernel (ops/svf_cuda.py).
- the texture of voice streams: poly_echo's voices and post chain with
  each voice's notes drawn from a stream of its own (texture_voice_song),
  so the rank of a sharded render builds its block of voices alone
  (texture_block_build).

render_config is the entry point; it renders on the card unless the
caller asks for the CPU.
"""

import os
from typing import List, Optional

import numpy as np
import torch

from ..core.mixdown import mixdown_s16
from ..core.notes import SongEvent
from ..core.timeline import SubvoiceTimeline, compile_timelines
from ..core.wav import read_wav
from ..device import require_device
from ..graph.render import Performance, render_performance
from ..ops import delay as d_ops
from ..ops import effects
from ..ops import sampler as sampler_ops
from ..ops.segprog import SegProgram, eval_chunk
from ..parallel.mesh import pad_timelines
from ..trace import span
from . import instruments as ti

F32 = np.float32

DRUMLOOP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "zang_tpu", "data", "drumloop.wav")

SAMPLE_RATE = 44100.0
MIX_VOLUME = 0.25
DEFAULT_SECONDS = {"sampler": 10.0, "poly_echo": 30.0}


class SamplerInstrument:
    """Looped WAV playback * 2.5 -> overdrive -> decimator.

    speed scales the sample's nominal rate (negative plays in reverse);
    fake_sample_rate enables the decimator (None bypasses it). table, if
    given, replaces reading wav_path (convert passes the JAX package's)."""

    def __init__(
        self,
        wav_path: str = DRUMLOOP,
        loop: bool = True,
        speed: float = 1.0,
        distort: bool = True,
        fake_sample_rate: Optional[float] = None,
        channel: int = 0,
        table: Optional[sampler_ops.SampleTable] = None,
    ) -> None:
        if table is None:
            table = sampler_ops.decode_wav_channel(read_wav(wav_path), channel)
        self.table = table
        self.loop = loop
        self.speed = speed
        self.distort = distort
        self.fake_sample_rate = fake_sample_rate
        self._device_tables = {}  # device -> f32 [num_samples] tensor

    def effective_sample_rate(self) -> float:
        return float(F32(F32(self.table.sample_rate) * F32(self.speed)))

    def plan(self, timelines: List[SubvoiceTimeline], sample_rate: float):
        table = sampler_ops.SampleTable(
            data_f32=self.table.data_f32,
            num_samples=self.table.num_samples,
            byte_len=self.table.byte_len,
            sample_rate=self.effective_sample_rate(),
        )
        progs = [sampler_ops.plan_sampler(tl, table, sample_rate, self.loop)
                 for tl in timelines]
        # merge the single-voice programs into one [V, K] SegProgram
        K = max(p.starts.shape[1] for p in progs)
        V = len(progs)
        starts = np.full((V, K), timelines[0].total, dtype=np.int64)
        values = {k: np.zeros((V, K), dtype=v.dtype) for k, v in progs[0].values.items()}
        for v, p in enumerate(progs):
            k = p.starts.shape[1]
            starts[v, :k] = p.starts[0]
            for name in values:
                values[name][v, :k] = p.values[name][0]
                values[name][v, k:] = p.values[name][0, k - 1]
        self.ratio = float(F32(F32(self.effective_sample_rate()) / F32(sample_rate)))
        return {"sampler": SegProgram(starts=starts, values=values)}

    def init_state(self, num_voices: int, device):
        return {
            "dec_cnt": torch.full((num_voices,), 0xFFFFFFFF, dtype=torch.int64,
                                  device=device),  # u32 in int64 (ops/scan.py)
            "dec_val": torch.zeros((num_voices,), dtype=torch.float32, device=device),
        }

    def _device_table(self, device) -> torch.Tensor:
        if device not in self._device_tables:
            self._device_tables[device] = torch.as_tensor(
                np.asarray(self.table.data_f32, F32), device=device)
        return self._device_tables[device]

    def render(self, state, prog, ctx):
        table = self._device_table(ctx.t_idx.device)
        p = prog["sampler"]
        if "tb" in p:  # the tiled chunk format: the whole chunk in one launch
            out = sampler_ops.sampler_play(p, ctx.t_idx, table, self.table.num_samples,
                                           self.ratio, self.loop)
        else:
            out = sampler_ops.eval_sampler(eval_chunk(p, ctx.t_idx), ctx.t_idx, table,
                                           self.table.num_samples, self.ratio, self.loop)
        out = out * 2.5  # example_sampler.zig:106
        if self.distort:
            out = effects.distortion(out, "overdrive", 0.9, 0.5, 0.0)
        if self.fake_sample_rate is not None:
            cnt, val, out = effects.decimator(
                state["dec_cnt"], state["dec_val"], out,
                self.fake_sample_rate, ctx.sample_rate)
            state = {"dec_cnt": cnt, "dec_val": val}
        return state, out


def build_sampler_performance(
    seconds: float = 10.0,
    sample_rate: float = SAMPLE_RATE,
    speed: float = 1.0,
    distort: bool = True,
    fake_sample_rate: Optional[float] = 6000.0,
):
    """Host: (Performance, total frames) of one looped drum-loop voice."""
    total = int(seconds * sample_rate)
    song = [SongEvent({"note_on": True}, t=0.0, note_id=1)]
    tls = compile_timelines(song, 1, sample_rate, total)
    inst = SamplerInstrument(speed=speed, distort=distort,
                             fake_sample_rate=fake_sample_rate)
    return Performance([(inst, tls)], sample_rate), total


def make_texture_song(num_voices: int, seconds: float, seed: int = 0):
    """Per-voice event lists: each voice plays continuous retriggered notes."""
    rng = np.random.default_rng(seed)
    note_len = 0.22
    gap = 0.25
    songs = []
    for _ in range(num_voices):
        song = []
        t = rng.uniform(0.0, 0.1)
        nid = 1
        while t < seconds - 0.3:
            f = float(F32(110.0 * 2 ** (rng.integers(0, 37) / 12.0)))
            song.append(SongEvent({"freq": f, "note_on": True}, t=t, note_id=nid))
            song.append(SongEvent({"freq": f, "note_on": False}, t=t + note_len,
                                  note_id=nid))
            nid += 1
            t += gap
        songs.append(song)
    return songs


def texture_voice_song(seconds: float, seed: int, voice: int):
    """One voice's events in the texture of voice streams: make_texture_song's
    voice (a start in [0, 0.1) s, then a note of 0.22 s every 0.25 s at one
    of 37 semitones from 110 Hz, up to 0.3 s before the end), its draws
    from a stream of its own, keyed by (seed, voice)."""
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


def texture_block_build(num_voices: int, seconds: float, sample_rate: float,
                        main_delay: int, seed: int, rank: int, world: int):
    """Host: (parts, sample_rate, perf_kwargs) of rank `rank`'s block of the
    texture of voice streams, as a RenderJob's build returns them (wrap the
    first five arguments in functools.partial): the voices [rank P,
    (rank + 1) P) of num_voices, P = num_voices / world rounded up, drawn
    and compiled alone, padded with silent voices to P; the post chain made
    for num_voices (its 1/num_voices scale is the whole texture's). At
    world 1 it is the whole texture."""
    per = -(-num_voices // world)
    lo, hi = rank * per, min(num_voices, (rank + 1) * per)
    if not 0 <= lo < hi:
        raise ValueError(f"rank {rank} of {world} holds none of {num_voices} voices")
    total = int(seconds * sample_rate)
    tls = [compile_timelines(texture_voice_song(seconds, seed, v), 1, sample_rate, total)[0]
           for v in range(lo, hi)]
    post_fn, post_init = poly_echo_post(num_voices, main_delay)
    return ([(ti.NiceInstrument(0.3), pad_timelines(tls, per))], sample_rate,
            dict(num_channels=2, post_fn=post_fn, post_init_state=post_init))


def render_poly_echo_oracle(num_voices: int = 1024, seconds: float = 30.0,
                            frames: Optional[int] = None,
                            sample_rate: float = SAMPLE_RATE, main_delay: int = 15000,
                            seed: int = 0) -> np.ndarray:
    """poly_echo's oracle twin on the host (the JAX package's
    tests/test_configs.py TestPolyEchoConfig): a NiceInstrument(0.3) a voice
    through the oracle's voice stack, the mix scaled by 1/num_voices into
    StereoEchoes(main_delay), in parity mode. The piece is the one of
    `seconds` (make_texture_song); its first `frames` are rendered (default
    all of it). Returns f32 [2, frames]."""
    from ..oracle import engine as oe
    from ..oracle import instruments as oi

    total = int(seconds * sample_rate) if frames is None else frames
    voices = [oe.Voice(song, 1, lambda: oi.NiceInstrument(0.3, mode="parity"),
                       lambda sr, p: {"sample_rate": sr, "freq": p["freq"],
                                      "note_on": p["note_on"]})
              for song in make_texture_song(num_voices, seconds, seed)]
    echo = oi.StereoEchoes(main_delay, mode="parity")
    scale = F32(1.0 / max(num_voices, 1))
    mixbuf = np.zeros(1024, dtype=np.float32)

    def paint(span, outputs, temps):
        mixbuf[span.start:span.end] = 0.0
        for v in voices:
            v.paint(span, sample_rate, [mixbuf], temps[:2])
        mixbuf[span.start:span.end] *= scale
        echo.paint(span, outputs, temps, False, {
            "input": mixbuf, "feedback_volume": 0.6, "cutoff": 0.7})

    return oe.render_blocks(paint, total, num_outputs=2, num_temps=4)


def poly_echo_post(num_voices: int, main_delay: int):
    """The poly_echo post chain: (post_fn, post_init_state). The mix is
    scaled by 1/num_voices (rounded to f32) into StereoEchoes(main_delay)
    with feedback 0.6 and cutoff 0.7."""
    scale = float(F32(1.0 / max(num_voices, 1)))

    def post_fn(state, mix, ctx):
        return d_ops.stereo_echoes(state, mix * scale, 0.6, 0.7)

    post_fn.capturable = True  # device work alone (graph/render.py)

    def post_init(device):
        return d_ops.stereo_echoes_init(main_delay, device)

    return post_fn, post_init


def poly_echo_build(
    num_voices: int = 1024,
    seconds: float = 30.0,
    sample_rate: float = SAMPLE_RATE,
    main_delay: int = 15000,
    seed: int = 0,
    multiple: int = 1,
):
    """Host: (parts, sample_rate, perf_kwargs) of poly_echo, as
    parallel.render_performance_sharded's `build` returns them (wrap it in
    functools.partial): num_voices NiceInstrument voices padded with
    silent ones to a multiple of `multiple`, and the post chain made for
    num_voices (its 1/num_voices scale is the whole piece's, whatever
    share of the voices a rank renders)."""
    total = int(seconds * sample_rate)
    tls = [compile_timelines(song, 1, sample_rate, total)[0]
           for song in make_texture_song(num_voices, seconds, seed)]
    post_fn, post_init = poly_echo_post(num_voices, main_delay)
    return ([(ti.NiceInstrument(0.3), pad_timelines(tls, multiple))], sample_rate,
            dict(num_channels=2, post_fn=post_fn, post_init_state=post_init))


def build_poly_echo_performance(
    num_voices: int = 1024,
    seconds: float = 30.0,
    sample_rate: float = SAMPLE_RATE,
    main_delay: int = 15000,
    seed: int = 0,
):
    """Host: (Performance, total frames) of num_voices NiceInstrument
    voices -> mono mix -> StereoEchoes, stereo."""
    with span("plan"):
        parts, sr, kw = poly_echo_build(num_voices, seconds, sample_rate, main_delay, seed)
        return Performance(parts, sr, **kw), int(seconds * sample_rate)


def build_config(name: str, seconds: Optional[float] = None, voices: int = 1024):
    """Host: (Performance, total frames) of the sampler or poly_echo config
    with the JAX CLI's defaults (10 s and 30 s at 44.1 kHz; poly_echo with
    `voices` voices). Planning 16384 voices takes tens of seconds."""
    seconds = DEFAULT_SECONDS[name] if seconds is None else seconds
    if name == "sampler":
        return build_sampler_performance(seconds=seconds)
    if name == "poly_echo":
        return build_poly_echo_performance(num_voices=voices, seconds=seconds)
    raise ValueError(f"unknown config {name!r} (sampler or poly_echo)")


def render_config(name: str, seconds: Optional[float] = None, voices: int = 1024,
                  chunk_size: int = 65536, *, device="cuda") -> torch.Tensor:
    """Render build_config(name, seconds, voices) on `device` -> f32
    [C, total] on that device (C = 1 for sampler, 2 for poly_echo). From
    4096 voices on, poly_echo renders by groups of voices through the
    one-pass SVF kernel (host/instruments.py NiceInstrument)."""
    dev = require_device(device)  # before planning: fail fast
    perf, total = build_config(name, seconds, voices)
    return render_performance(perf, total, chunk_size=chunk_size, device=dev)


def render_config_s16(name: str, seconds: Optional[float] = None, voices: int = 1024,
                      chunk_size: int = 65536, *, device="cuda") -> np.ndarray:
    """render_config mixed down at volume 0.25 on `device`; returns int16
    [C, total] on the host."""
    return mixdown_s16(render_config(name, seconds, voices, chunk_size, device=device),
                       MIX_VOLUME).cpu().numpy()
