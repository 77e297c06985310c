"""Trigger: split a mix block into per-note spans (host side).

Reference: src/zang/trigger.zig. A Trigger is fed ImpulsesAndParamses and
yields (span, params, note_id_changed) tuples — a new tuple whenever a new
note id begins. Once a note has started it is remembered forever (so release
tails keep rendering, trigger.zig:38-41). Same-frame impulses: the later one
wins (trigger.zig:167-178).

In the TPU build the Trigger runs on the host as part of timeline
compilation; its output spans become dense segment tensors.

A copy of zang_tpu/core/trigger.py (the port imports nothing of zang_tpu).

Frozen for the benchmark from zang_tpu_torch/core/trigger.py: only the imports differ,
so the reference imports nothing of the port.
"""

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

from .notes import ImpulsesAndParamses, Params
from .span import Span


@dataclass(frozen=True)
class NoteSpanResult:
    span: Span
    params: Params
    note_id_changed: bool


@dataclass
class _Note:
    id: int
    params: Params


class Trigger:
    def __init__(self) -> None:
        self.note: Optional[_Note] = None

    def reset(self) -> None:
        self.note = None

    def iterate(self, span: Span, iap: ImpulsesAndParamses) -> Iterator[NoteSpanResult]:
        """Yield note spans covering [span.start, span.end) left to right."""
        impulses = iap.impulses
        paramses = iap.paramses
        idx = 0
        start = span.start
        end = span.end

        while start < end:
            carried = self._carry_over(start, end, impulses, idx)
            if carried is not None:
                seg_start, seg_end, note = carried
            else:
                seg_start, seg_end, note, idx = self._next_note_span(
                    start, end, impulses, paramses, idx
                )
            start = seg_end

            if note is not None:
                note_id_changed = self.note is None or note.id != self.note.id
                self.note = note
                yield NoteSpanResult(
                    span=Span(seg_start, seg_end),
                    params=note.params,
                    note_id_changed=note_id_changed,
                )

    def _carry_over(
        self, start: int, end: int, impulses, idx
    ) -> Optional[Tuple[int, int, _Note]]:
        """Continue the current note until the next impulse (trigger.zig:107-141).

        Returns None when there is no current note, or the next impulse starts
        right now (so the caller should take impulses instead).
        """
        if self.note is None:
            return None
        if idx < len(impulses):
            next_frame = impulses[idx].frame
            if next_frame > start:
                return start, min(end, next_frame), self.note
            return None
        return start, end, self.note

    def _next_note_span(
        self, start: int, end: int, impulses, paramses, idx
    ) -> Tuple[int, int, Optional[_Note], int]:
        """Take the next impulse(s) from the stream (trigger.zig:143-196)."""
        i = idx
        while i < len(impulses):
            impulse = impulses[i]
            if impulse.frame >= end:
                break  # impulse past the end of the buffer; shouldn't happen
            if impulse.frame > start:
                # gap before the note begins: silent span, no note
                return start, impulse.frame, None, i
            assert impulse.frame == start
            i += 1
            # span ends at the next impulse or the end of the buffer
            if i < len(impulses):
                note_end = min(end, impulses[i].frame)
            else:
                note_end = end
            if note_end <= start:
                # next impulse starts at the same frame: later one wins
                continue
            return start, note_end, _Note(id=impulse.note_id, params=paramses[i - 1]), i
        return start, end, None, i
