"""Note/impulse event system (host side).

Semantics follow the reference exactly (src/zang/notes.zig), including its
quirks, because note *timing* feeds the golden-WAV comparison:

- ImpulseQueue: fixed 32-slot queue; silently drops pushes that overflow or
  are out of chronological order (notes.zig:102-127).
- NoteTracker: converts song-event times (f32 seconds) to impulse frames one
  mix block at a time, with f32 accumulation of block time — frame positions
  depend on that f32 arithmetic, so we reproduce it with np.float32
  (notes.zig:162-206).
- PolyphonyDispatcher: routes impulses to a fixed number of voice slots.
  Note-off matches the slot holding the same note_id; note-on picks the first
  empty slot, else the slot with the oldest *released* event_id, else steals
  the oldest note-on (notes.zig:246-306).

Params are plain dicts. The dispatcher reads params["note_on"] — the only
place the core looks at note_on, mirroring the reference (notes.zig:29-35).

A copy of zang_tpu/core/notes.py (the port imports nothing of zang_tpu).
The timeline compiler (core/timeline.py) runs the tracker, dispatcher and
trigger in the native compiler; these Python classes serve callers that
walk notes block by block themselves.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .span import Span

# the reference's fixed capacity for impulses per block (notes.zig:74-75)
QUEUE_CAPACITY = 32

Params = Dict[str, Any]


@dataclass(frozen=True)
class Impulse:
    frame: int  # absolute frame within the current mix block
    note_id: int
    event_id: int


@dataclass
class ImpulsesAndParamses:
    impulses: List[Impulse] = field(default_factory=list)
    paramses: List[Params] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.impulses)


class IdGenerator:
    """Auto-incrementing note id source (notes.zig:43-56)."""

    def __init__(self) -> None:
        self.next_id = 1

    def next(self) -> int:
        nid = self.next_id
        self.next_id += 1
        return nid


class ImpulseQueue:
    """Queue the outside world pushes impulses into; drained per block.

    Matches reference behavior: capacity 32, silently ignores pushes that are
    out of order or overflow (notes.zig:102-127).
    """

    def __init__(self) -> None:
        self._impulses: List[Impulse] = []
        self._paramses: List[Params] = []
        self.next_event_id = 1

    def push(self, impulse_frame: int, note_id: int, params: Params) -> None:
        if len(self._impulses) >= QUEUE_CAPACITY:
            return
        if self._impulses and impulse_frame < self._impulses[-1].frame:
            return
        self._impulses.append(
            Impulse(frame=impulse_frame, note_id=note_id, event_id=self.next_event_id)
        )
        self._paramses.append(params)
        self.next_event_id += 1

    def consume(self) -> ImpulsesAndParamses:
        out = ImpulsesAndParamses(self._impulses, self._paramses)
        self._impulses = []
        self._paramses = []
        return out


@dataclass(frozen=True)
class SongEvent:
    """A canned song note event at time t seconds (notes.zig:130-136)."""

    params: Params
    t: float
    note_id: int


class NoteTracker:
    """Follow a canned song, emitting impulses for each mix block.

    Timing arithmetic is float32 to match the reference bit-for-bit: the
    tracker accumulates block time `t += out_len / sample_rate` in f32, and
    each event's frame is `min(int(f * out_len), out_len - 1)` where
    `f = (note_t - t) / buf_time` (notes.zig:162-206).

    Deliberate deviation: the reference stores impulses in a fixed 32-slot
    array with no overflow guard ("TODO - do something graceful-ish",
    notes.zig:184-185 — a debug panic / UB past 32 events per block); this
    tracker is unbounded, which only differs where the reference would
    crash.
    """

    def __init__(self, song: List[SongEvent]) -> None:
        self.song = song
        self.next_song_event = 0
        self.t = np.float32(0.0)

    def reset(self) -> None:
        self.next_song_event = 0
        self.t = np.float32(0.0)

    def consume(self, sample_rate: float, span: Span) -> ImpulsesAndParamses:
        out = ImpulsesAndParamses()
        out_len = span.end - span.start
        buf_time = np.float32(np.float32(out_len) / np.float32(sample_rate))
        end_t = np.float32(self.t + buf_time)

        start_t = self.t
        while self.next_song_event < len(self.song):
            ev = self.song[self.next_song_event]
            note_t = np.float32(ev.t)
            if note_t < start_t:
                # the reference asserts chronological order (notes.zig:173)
                raise ValueError(
                    f"song events out of order: event {self.next_song_event} at "
                    f"t={float(note_t)} is before tracker clock {float(start_t)}"
                )
            if not (note_t < end_t):
                break
            f = np.float32(np.float32(note_t - self.t) / buf_time)  # 0..1
            rel_frame_index = min(int(np.float32(f * np.float32(out_len))), out_len - 1)
            self.next_song_event += 1
            out.impulses.append(
                Impulse(
                    frame=span.start + rel_frame_index,
                    note_id=ev.note_id,
                    event_id=self.next_song_event,
                )
            )
            out.paramses.append(ev.params)
            start_t = note_t

        self.t = end_t
        return out


@dataclass
class _SlotState:
    note_id: int
    event_id: int
    note_on: bool


class PolyphonyDispatcher:
    """Route impulses to `polyphony` voice slots (notes.zig:209-348)."""

    def __init__(self, polyphony: int) -> None:
        self.polyphony = polyphony
        self.slots: List[Optional[_SlotState]] = [None] * polyphony

    def reset(self) -> None:
        self.slots = [None] * self.polyphony

    def _choose_slot(self, note_id: int, event_id: int, note_on: bool) -> Optional[int]:
        if not note_on:
            # note-off: find the slot where this note lives (must still be on)
            for slot_index, slot in enumerate(self.slots):
                if slot is not None and slot.note_id == note_id and slot.note_on:
                    return slot_index
            return None
        # note-on: first empty slot wins immediately; otherwise the released
        # slot with the oldest event_id
        best: Optional[int] = None
        for slot_index, slot in enumerate(self.slots):
            if slot is None:
                return slot_index
            if not slot.note_on:
                if best is None or slot.event_id < self.slots[best].event_id:
                    best = slot_index
        if best is not None:
            return best
        # no choice: steal the slot with the oldest note-on
        best = 0
        for slot_index in range(1, self.polyphony):
            if self.slots[slot_index].event_id < self.slots[best].event_id:
                best = slot_index
        return best

    def dispatch(self, iap: ImpulsesAndParamses) -> List[ImpulsesAndParamses]:
        result = [ImpulsesAndParamses() for _ in range(self.polyphony)]
        for impulse, params in zip(iap.impulses, iap.paramses):
            slot_index = self._choose_slot(
                impulse.note_id, impulse.event_id, bool(params["note_on"])
            )
            if slot_index is None:
                continue
            self.slots[slot_index] = _SlotState(
                note_id=impulse.note_id,
                event_id=impulse.event_id,
                note_on=bool(params["note_on"]),
            )
            result[slot_index].impulses.append(impulse)
            result[slot_index].paramses.append(params)
        return result
