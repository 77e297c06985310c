"""Oracle render engine: the reference's block/voice driver (a copy of
zang_tpu/oracle/engine.py).

Mirrors the offline render loop (examples/write_wav.zig:56-93) and the
polyphonic Voice stack (examples/example_song.zig:287-351): per block, a
NoteTracker emits impulses, a PolyphonyDispatcher routes them to subvoices,
and each subvoice's Trigger splits the block into note spans painted by its
module instance.

Frozen for the benchmark from zang_tpu_torch/oracle/engine.py: only the imports differ,
so the reference imports nothing of the port.
"""

from typing import Callable, List, Optional

import numpy as np

from .mixdown import mixdown_s16_np
from .notes import NoteTracker, PolyphonyDispatcher, SongEvent
from .span import Span
from .trigger import Trigger


class Voice:
    """Polyphonic voice stack: tracker + dispatcher + per-slot trigger/module."""

    def __init__(
        self,
        song: List[SongEvent],
        polyphony: int,
        make_module: Callable[[], object],
        make_params: Callable[[float, dict], dict],
    ) -> None:
        self.tracker = NoteTracker(song)
        self.dispatcher = PolyphonyDispatcher(polyphony)
        self.sub_voices = [
            {"module": make_module(), "trigger": Trigger()} for _ in range(polyphony)
        ]
        self.make_params = make_params

    def reset(self) -> None:
        self.tracker.reset()
        self.dispatcher.reset()
        for sv in self.sub_voices:
            sv["trigger"].reset()

    def paint(self, span: Span, sample_rate: float, outputs, temps) -> None:
        iap = self.tracker.consume(sample_rate, span)
        poly_iap = self.dispatcher.dispatch(iap)
        for sv, sub_iap in zip(self.sub_voices, poly_iap):
            for result in sv["trigger"].iterate(span, sub_iap):
                sv["module"].paint(
                    result.span,
                    outputs,
                    temps,
                    result.note_id_changed,
                    self.make_params(sample_rate, result.params),
                )


def render_blocks(
    paint_fn: Callable[[Span, list, list], None],
    total_frames: int,
    num_outputs: int = 1,
    num_temps: int = 0,
    block_size: int = 1024,
) -> np.ndarray:
    """Drive paint_fn over consecutive blocks; returns f32 [num_outputs, total].

    paint_fn(span, outputs, temps) must add into outputs (zeroed per block),
    exactly like MainModule.paint in the reference host.
    """
    out = np.zeros((num_outputs, total_frames), dtype=np.float32)
    outputs = [np.zeros(block_size, dtype=np.float32) for _ in range(num_outputs)]
    temps = [np.zeros(block_size, dtype=np.float32) for _ in range(num_temps)]
    start = 0
    while start < total_frames:
        length = min(block_size, total_frames - start)
        span = Span(0, length)
        for o in outputs:
            o[:length] = 0.0
        paint_fn(span, outputs, temps)
        for c in range(num_outputs):
            out[c, start : start + length] = outputs[c][:length]
        start += length
    return out


def render_to_s16(
    paint_fn,
    total_frames: int,
    num_outputs: int = 1,
    num_temps: int = 0,
    block_size: int = 1024,
    vol: float = 0.25,
) -> np.ndarray:
    """Full offline render to int16 (the write_wav.zig golden path)."""
    mix = render_blocks(paint_fn, total_frames, num_outputs, num_temps, block_size)
    return mixdown_s16_np(mix, vol)
