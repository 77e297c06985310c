"""The benchmark's plain references: the oracle (engine, modules and
instruments of this package, numpy and C++ on the host) rendering what each
cell's timed path renders, from the same inputs the benchmark hands the
program.

- song_oracle: the Toccata of write_wav.zig (Pedal, RegularOrgan and
  WeirdOrgan voice stacks), transposed, mixed down to s16 at 0.25;
  zang_tpu_torch/host/song.py render_song_oracle with the song passed in.
- texture_oracle: poly_echo's twin (zang_tpu_torch/host/configs.py
  render_poly_echo_oracle): a NiceInstrument(0.3) a voice, the mix at 1/V
  into StereoEchoes(15000), over its first `frames`, mixed down to s16. The
  voices may be split over worker processes; each sums its voices in order
  and the partial mixes are added in worker order (one worker gives the
  twin's bits).
- live_lane_oracle: one live lane, NiceInstrument(0.3) at polyphony 4, its
  events applied at the absolute frames where the fleet applies them.

precision="bf16" is the control of the benchmark's comparison: the same
reference with every voice's signal, and the echoes' input and output,
rounded to bfloat16 before it is added into the f32 mix (the step that would
tempt a later change: storing the [V, n] voice buffers in bfloat16).

Imports numpy and this package only: nothing of the port, nothing of JAX.
"""

from typing import List, Sequence

import numpy as np

from . import engine as oe
from . import instruments as oi
from .mixdown import mixdown_s16_np
from .notes import Impulse, ImpulsesAndParamses, SongEvent
from .span import Span

F32 = np.float32
BLOCK = 1024  # the oracle's mix block (engine.render_blocks)
PRECISIONS = ("f32", "bf16")


def bf16(a: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bfloat16 (ties to even), as f32."""
    u = np.ascontiguousarray(a, F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def _paint_voices(voices, span, sample_rate, out, temps, scratch, precision):
    """Each voice stack adds into out[span]; under bf16 a voice's signal is
    rounded before it is added."""
    if precision == "f32":
        for v in voices:
            v.paint(span, sample_rate, [out], temps)
        return
    sl = slice(span.start, span.end)
    for v in voices:
        scratch[sl] = 0.0
        v.paint(span, sample_rate, [scratch], temps)
        out[sl] += bf16(scratch[sl])


def _check(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} (one of {PRECISIONS})")


# ---------------------------------------------------------------------------
# the Toccata


def song_events(song: Sequence[dict]) -> List[List[SongEvent]]:
    """The benchmark's plain song ([{t, note_id, freq, note_on} arrays] a
    part) as this package's SongEvent lists."""
    return [[SongEvent({"freq": float(f), "note_on": bool(on)}, t=float(t), note_id=int(n))
             for t, n, f, on in zip(p["t"], p["note_id"], p["freq"], p["note_on"])]
            for p in song]


def song_oracle(song: Sequence[dict], frames: int, sample_rate: float = 48000.0,
                volume: float = 0.25, precision: str = "f32") -> np.ndarray:
    """The song's first `frames` through the oracle (parity mode), s16
    [frames]. song: three parts (Pedal, RegularOrgan, WeirdOrgan)."""
    _check(precision)
    parts = song_events(song)

    def pedal_params(sr, p):  # example_song.zig:36: freq * 0.5 in f32
        return {"sample_rate": sr, "freq": F32(F32(p["freq"]) * F32(0.5)),
                "note_on": p["note_on"]}

    def params(sr, p):
        return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}

    voices = [
        oe.Voice(parts[0], 3, lambda: oi.PMOscInstrument(0.4, mode="parity"), pedal_params),
        oe.Voice(parts[1], 10, lambda: oi.NiceInstrument(0.25, mode="parity"), params),
        oe.Voice(parts[2], 4, lambda: oi.NiceInstrument(0.1, mode="parity"), params),
    ]
    scratch = np.zeros(BLOCK, F32)

    def paint(span, outputs, temps):
        _paint_voices(voices, span, sample_rate, outputs[0], temps, scratch, precision)

    mix = oe.render_blocks(paint, frames, num_outputs=1, num_temps=3)
    return mixdown_s16_np(mix, volume)[0]


# ---------------------------------------------------------------------------
# the texture (poly_echo)


def make_texture_song(num_voices: int, seconds: float, seed: int = 0) -> List[List[SongEvent]]:
    """Per-voice event lists, each voice continuous retriggered notes:
    zang_tpu_torch/host/configs.py make_texture_song, frozen."""
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


def _texture_params(sr, p):
    return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}


def texture_voice_mix(songs, frames: int, sample_rate: float,
                      precision: str = "f32") -> np.ndarray:
    """The unscaled sum of these voices over [0, frames), f32, painted block
    by block in voice order (the twin's mixbuf before its 1/V scale)."""
    _check(precision)
    voices = [oe.Voice(song, 1, lambda: oi.NiceInstrument(0.3, mode="parity"),
                       _texture_params) for song in songs]
    scratch = np.zeros(BLOCK, F32)

    def paint(span, outputs, temps):
        _paint_voices(voices, span, sample_rate, outputs[0], temps[:2], scratch, precision)

    return oe.render_blocks(paint, frames, num_outputs=1, num_temps=2)[0]


def _texture_worker(args):
    num_voices, seconds, seed, lo, hi, frames, sample_rate, precision = args
    songs = make_texture_song(num_voices, seconds, seed)[lo:hi]
    return texture_voice_mix(songs, frames, sample_rate, precision)


def texture_oracle(num_voices: int, seconds: float, seed: int, frames: int,
                   sample_rate: float = 44100.0, main_delay: int = 15000,
                   volume: float = 0.25, precision: str = "f32",
                   workers: int = 1) -> np.ndarray:
    """poly_echo's first `frames` through the oracle, s16 [2, frames]. The
    voices split into `workers` contiguous groups, each rendered in a
    spawned process (numpy and this package only) when workers > 1."""
    _check(precision)
    workers = max(1, min(workers, num_voices))
    bounds = [round(num_voices * w / workers) for w in range(workers + 1)]
    jobs = [(num_voices, seconds, seed, lo, hi, frames, sample_rate, precision)
            for lo, hi in zip(bounds[:-1], bounds[1:])]
    if workers == 1:
        partials = [_texture_worker(jobs[0])]
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # spawned: the workers import numpy and this package, never the
        # program; a worker that dies raises here instead of hanging
        with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
            partials = list(pool.map(_texture_worker, jobs))
    mix = partials[0]
    for p in partials[1:]:
        mix = mix + p
    echo = oi.StereoEchoes(main_delay, mode="parity")
    scale = F32(1.0 / max(num_voices, 1))
    mixbuf = np.zeros(BLOCK, F32)

    def paint(span, outputs, temps):
        n = span.end - span.start
        c0 = paint.c0
        mixbuf[:n] = mix[c0:c0 + n]
        mixbuf[:n] *= scale
        if precision == "bf16":
            mixbuf[:n] = bf16(mixbuf[:n])
        echo.paint(span, outputs, temps, False, {
            "input": mixbuf, "feedback_volume": 0.6, "cutoff": 0.7})
        if precision == "bf16":
            for o in outputs:
                o[:n] = bf16(o[:n])
        paint.c0 += n

    paint.c0 = 0
    out = oe.render_blocks(paint, frames, num_outputs=2, num_temps=4)
    return mixdown_s16_np(out, volume)


# ---------------------------------------------------------------------------
# a live lane


class FrameTracker:
    """NoteTracker's role for a live lane: each event's impulse at the
    absolute frame where the fleet applied it. events: (frame, note_id,
    freq, note_on) in frame order; event ids count from 1, as the live
    ImpulseQueue gives them."""

    def __init__(self, events) -> None:
        self.events = list(events)
        self.next = 0
        self.frame = 0

    def consume(self, sample_rate: float, span: Span) -> ImpulsesAndParamses:
        out = ImpulsesAndParamses()
        end = self.frame + (span.end - span.start)
        while self.next < len(self.events) and self.events[self.next][0] < end:
            f, nid, freq, on = self.events[self.next]
            self.next += 1
            out.impulses.append(Impulse(frame=span.start + int(f) - self.frame,
                                        note_id=int(nid), event_id=self.next))
            out.paramses.append({"freq": float(freq), "note_on": bool(on)})
        self.frame = end
        return out


def live_lane_oracle(events, frames: int, sample_rate: float = 48000.0,
                     polyphony: int = 4, color: float = 0.3,
                     precision: str = "f32") -> np.ndarray:
    """One lane's first `frames`, f32 [frames]: NiceInstrument(color) at
    `polyphony`, the events at their frames."""
    _check(precision)
    voice = oe.Voice([], polyphony, lambda: oi.NiceInstrument(color, mode="parity"),
                     _texture_params)
    voice.tracker = FrameTracker(events)
    scratch = np.zeros(BLOCK, F32)

    def paint(span, outputs, temps):
        _paint_voices([voice], span, sample_rate, outputs[0], temps[:2], scratch, precision)

    return oe.render_blocks(paint, frames, num_outputs=1, num_temps=2)[0]


def deviation(a: np.ndarray, b: np.ndarray) -> dict:
    """{rms_dbfs, peak_dbfs} of a - b, full scale 1.0 (s16 / 32767):
    zang_tpu_torch/graph/fidelity.py deviation_dbfs, frozen."""
    def f(x):
        x = np.asarray(x)
        return x.astype(np.float64) / 32767.0 if x.dtype == np.int16 else x.astype(np.float64)

    fa, fb = f(a), f(b)
    if fa.shape != fb.shape:
        raise ValueError(f"shapes differ: {fa.shape} vs {fb.shape}")
    d = fa - fb
    rms = float(np.sqrt(np.mean(d * d))) if d.size else 0.0
    peak = float(np.max(np.abs(d))) if d.size else 0.0
    return {"rms_dbfs": float(20.0 * np.log10(max(rms, 1e-12))),
            "peak_dbfs": float(20.0 * np.log10(max(peak, 1e-12)))}
