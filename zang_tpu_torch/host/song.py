"""The Bach Toccata & Fugue song on the port (zang_tpu/host/song.py).

Three instruments driven by zang_tpu/data/bach_toccata.npz:

  Pedal        = PMOscInstrument(release 0.4), freq * 0.5, polyphony 3
  RegularOrgan = NiceInstrument(color 0.25),               polyphony 10
  WeirdOrgan   = NiceInstrument(color 0.1),                polyphony 4

The two organs merge into one 14-voice part with a per-voice color, as in
the JAX package. Offline render config: 48 kHz, mono, 385 s, mixdown
volume 0.25, s16.
"""

import os
from typing import List

import numpy as np
import torch

from ..core.mixdown import mixdown_s16
from ..core.notes import SongEvent
from ..core.timeline import compile_timelines
from ..device import require_device
from ..graph.render import Performance, render_performance
from ..oracle import engine as oe
from ..oracle import instruments as oi
from ..parallel.mesh import pad_timelines
from ..trace import span
from . import instruments as ti

F32 = np.float32

SAMPLE_RATE = 48000.0
NUM_SECONDS = 6 * 60 + 25  # 385 (write_wav.zig:7)
MIX_VOLUME = 0.25

_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "zang_tpu", "data", "bach_toccata.npz")

PEDAL, REGULAR, WEIRD = 0, 1, 2
POLYPHONY = {PEDAL: 3, REGULAR: 10, WEIRD: 4}


def load_song() -> List[List[SongEvent]]:
    """Per-instrument chronological SongEvent lists."""
    z = np.load(_DATA)
    return [
        [
            SongEvent({"freq": float(f), "note_on": bool(on)}, t=float(t),
                      note_id=int(nid))
            for t, nid, f, on in zip(z[f"t_{i}"], z[f"id_{i}"], z[f"freq_{i}"],
                                     z[f"on_{i}"])
        ]
        for i in range(3)
    ]


def live_events(seconds: float, transpose: int = 0) -> List[SongEvent]:
    """The RegularOrgan part's events before `seconds` (50 notes in the
    first 10 s), transposed by `transpose` semitones in f32: the input of
    the live cells (a NiceInstrument session at polyphony 4 steals voices;
    a fleet gives each lane its own transposition). chip_smoke.py, the
    tests and tools/make_torch_golden.py feed them through a NoteTracker."""
    mul = F32(2.0 ** (transpose / 12.0))
    return [SongEvent({"freq": float(F32(F32(e.params["freq"]) * mul)),
                       "note_on": e.params["note_on"]}, t=e.t, note_id=e.note_id)
            for e in load_song()[REGULAR] if e.t < seconds]


def pedal_freq(p) -> F32:
    # example_song.zig:36: freq * 0.5 in f32
    return F32(F32(p["freq"]) * F32(0.5))


def song_parts(total_frames: int, song=None, multiple: int = 1,
               three_part: bool = False) -> list:
    """[(instrument, timelines)] of the song over [0, total_frames): the
    Pedal and the two organs merged into one part with a per-voice color,
    or, with three_part, each organ a part of its own with its scalar
    color (tests/test_parallel.py:27-38). Each part is padded with silent
    voices to a multiple of `multiple` (parallel/mesh.py pad_timelines);
    the merged organ's pad voices take its last color."""
    song = song or load_song()
    tls = [
        compile_timelines(song[i], POLYPHONY[i], SAMPLE_RATE, total_frames)
        for i in range(3)
    ]
    pedal = ti.PMOscInstrument(0.4, freq_fn=pedal_freq)
    if three_part:
        parts = [(pedal, tls[PEDAL]), (ti.NiceInstrument(0.25), tls[REGULAR]),
                 (ti.NiceInstrument(0.1), tls[WEIRD])]
    else:
        organ = tls[REGULAR] + tls[WEIRD]
        colors = [0.25] * POLYPHONY[REGULAR] + [0.1] * POLYPHONY[WEIRD]
        colors += colors[-1:] * (-len(organ) % multiple)
        parts = [(pedal, tls[PEDAL]),
                 (ti.NiceInstrument(np.array(colors, np.float32)), organ)]
    return [(inst, pad_timelines(t, multiple)) for inst, t in parts]


def build_performance(total_frames: int, song=None) -> Performance:
    """Host: timelines and plans of the song over [0, total_frames)."""
    with span("plan"):
        return Performance(song_parts(total_frames, song), SAMPLE_RATE)


def song_build(total_frames: int, multiple: int = 1, three_part: bool = False):
    """The song as parallel.render_performance_sharded's `build` takes it
    (wrap it in functools.partial): (song_parts(...), SAMPLE_RATE, {})."""
    return (song_parts(total_frames, multiple=multiple, three_part=three_part),
            SAMPLE_RATE, {})


def render_song(seconds: float = NUM_SECONDS, chunk_size: int = 65536, *,
                device="cuda") -> torch.Tensor:
    """Render the song on `device` (the card unless the caller asks for the
    CPU) -> f32 [total] mix (pre-mixdown), on that device."""
    dev = require_device(device)  # before planning: fail fast
    total = int(seconds * SAMPLE_RATE)
    perf = build_performance(total)
    return render_performance(perf, total, chunk_size=chunk_size, device=dev)[0]


def render_song_s16(seconds: float = NUM_SECONDS, chunk_size: int = 65536, *,
                    device="cuda") -> np.ndarray:
    """Render and mix down on `device`; returns int16 [total] on the host."""
    return mixdown_s16(render_song(seconds, chunk_size, device=device),
                       MIX_VOLUME).cpu().numpy()


# --------------------------------------------------------------------------
# The oracle twin (the golden source): the reference's block/span engine on
# the host (zang_tpu_torch/oracle), numpy, no device.


def build_oracle_voices(mode: str = "parity", song=None):
    """The song's three voice stacks for the oracle (the JAX package's
    build_oracle_voices): Pedal, RegularOrgan and WeirdOrgan, each its own
    NoteTracker, dispatcher and module a slot."""
    song = song or load_song()

    def mk_params_pedal(sr, p):
        return {"sample_rate": sr, "freq": pedal_freq(p), "note_on": p["note_on"]}

    def mk_params(sr, p):
        return {"sample_rate": sr, "freq": p["freq"], "note_on": p["note_on"]}

    return [
        oe.Voice(song[PEDAL], POLYPHONY[PEDAL],
                 lambda: oi.PMOscInstrument(0.4, mode=mode), mk_params_pedal),
        oe.Voice(song[REGULAR], POLYPHONY[REGULAR],
                 lambda: oi.NiceInstrument(0.25, mode=mode), mk_params),
        oe.Voice(song[WEIRD], POLYPHONY[WEIRD],
                 lambda: oi.NiceInstrument(0.1, mode=mode), mk_params),
    ]


def render_song_oracle(seconds: float = NUM_SECONDS, mode: str = "parity") -> np.ndarray:
    """The song through the oracle on the host -> f32 [total] mix
    (pre-mixdown); mode "parity" (the device contract) or "exact" (the
    reference's float accumulation)."""
    total = int(seconds * SAMPLE_RATE)
    voices = build_oracle_voices(mode)

    def paint(span, outputs, temps):
        for v in voices:
            v.paint(span, SAMPLE_RATE, outputs, temps)

    return oe.render_blocks(paint, total, num_outputs=1, num_temps=3)[0]
