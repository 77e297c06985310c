"""Tracker-style song text parser.

Format (examples/common/songparse1.zig): lines interleave words (`start`,
`rate N`, `tempo N`), `#` comments, and note rows:

    |C#4 A-4|off         G-5|

A note row holds fixed-width 3-char cells (note like `C#4`, `off`, or three
spaces for idle), separated by single spaces or `|`. Note letters C..B with
modifier `-` or `#`, octave digit; frequency = a4 * 2^((octave*12 - 57 +
semitone)/12) in f32 (songparse1.zig:29-63).

The higher-level note assembly (per-column note-off insertion, global note
ids, f32 time accumulation t += note_duration/(rate*tempo), per-timeslot
sort by note id) mirrors examples/example_song.zig:127-264.

A copy of zang_tpu/host/songparse.py (the port imports nothing of zang_tpu).
"""

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np

from ..core.notes import SongEvent

F32 = np.float32

_SEMITONES = {
    ("C", "-"): 0, ("C", "#"): 1, ("D", "-"): 2, ("D", "#"): 3,
    ("E", "-"): 4, ("F", "-"): 5, ("F", "#"): 6, ("G", "-"): 7,
    ("G", "#"): 8, ("A", "-"): 9, ("A", "#"): 10, ("B", "-"): 11,
}


@dataclass
class NoteCell:
    kind: str  # "idle" | "freq" | "off"
    freq: float = 0.0


@dataclass
class Token:
    kind: str  # "word" | "number" | "notes"
    word: str = ""
    number: float = 0.0
    notes: Optional[List[NoteCell]] = None


class SongParseError(ValueError):
    def __init__(self, line_index: int, msg: str = "syntax error"):
        super().__init__(f"line {line_index + 1}: {msg}")
        self.line_index = line_index


class Parser:
    def __init__(self, contents: str, num_columns: int, a4: float = 440.0):
        self.contents = contents
        self.num_columns = num_columns
        self.a4 = F32(a4)
        self.index = 0
        self.line_index = 0

    def _eat(self, prefix: str) -> bool:
        if self.contents.startswith(prefix, self.index):
            self.index += len(prefix)
            return True
        return False

    def _parse_note(self) -> Optional[float]:
        if self.index + 3 > len(self.contents):
            return None
        letter = self.contents[self.index]
        modifier = self.contents[self.index + 1]
        octave = self.contents[self.index + 2]
        if not octave.isdigit():
            return None
        semitone = _SEMITONES.get((letter, modifier))
        if semitone is None:
            return None
        self.index += 3
        offset = int(octave) * 12 - 57
        exp = F32(F32(offset + semitone) / F32(12.0))
        return float(F32(self.a4 * F32(np.float32(2.0) ** exp)))

    def parse_token(self) -> Optional[Token]:
        while True:
            if self._eat(" "):
                continue
            if self._eat("\n"):
                self.line_index += 1
                continue
            if self._eat("#"):
                pos = self.contents.find("\n", self.index)
                if pos < 0:
                    self.index = len(self.contents)
                else:
                    self.line_index += 1
                    self.index = pos + 1
                continue
            break
        if self.index >= len(self.contents):
            return None

        ch = self.contents[self.index]
        if ch == "|":
            self.index += 1
            notes = [NoteCell("idle") for _ in range(self.num_columns)]
            col = 0
            while True:
                if col >= self.num_columns:
                    raise SongParseError(self.line_index, "too many columns")
                freq = self._parse_note()
                if freq is not None:
                    notes[col] = NoteCell("freq", freq)
                elif self._eat("off"):
                    notes[col] = NoteCell("off")
                elif self._eat("   "):
                    pass
                else:
                    break
                col += 1
                if self.index < len(self.contents) and self.contents[self.index] in " |":
                    self.index += 1
                else:
                    break
            if self.index < len(self.contents):
                if self.contents[self.index] == "\n":
                    self.line_index += 1
                    self.index += 1
                else:
                    raise SongParseError(self.line_index)
            return Token("notes", notes=notes)

        if ch.isalpha() or ch == "_":
            start = self.index
            self.index += 1
            while self.index < len(self.contents) and (
                self.contents[self.index].isalnum() or self.contents[self.index] == "_"
            ):
                self.index += 1
            return Token("word", word=self.contents[start : self.index])

        if ch.isdigit():
            start = self.index
            dot = False
            self.index += 1
            while self.index < len(self.contents):
                c2 = self.contents[self.index]
                if c2 == ".":
                    if dot:
                        break
                    dot = True
                    self.index += 1
                elif c2.isdigit():
                    self.index += 1
                else:
                    break
            return Token("number", number=float(F32(self.contents[start : self.index])))

        raise SongParseError(self.line_index)

    def require_number(self) -> float:
        tok = self.parse_token()
        if tok is None or tok.kind != "number":
            raise SongParseError(self.line_index, "expected number")
        return tok.number


def parse_song(
    contents: str,
    columns_per_voice: List[int],
    note_duration: float = 0.15,
    a4: float = 440.0,
) -> List[List[SongEvent]]:
    """Parse tracker text into per-instrument chronological SongEvent lists.

    Mirrors example_song.zig doParse: global auto-increment note ids,
    per-column note-off insertion before a new note, f32 time accumulation,
    per-timeslot stable sort by note id (so offs precede ons).
    """
    total_columns = sum(columns_per_voice)
    parser = Parser(contents, total_columns, a4)

    col_to_instrument = []
    for idx, n in enumerate(columns_per_voice):
        col_to_instrument += [idx] * n

    events: List[List[SongEvent]] = [[] for _ in columns_per_voice]
    column_last_note = [None] * total_columns  # (freq, id)
    next_id = 1
    t = F32(0.0)
    rate = F32(1.0)
    tempo = F32(1.0)

    def make(tv, nid, freq, on):
        return SongEvent({"freq": freq, "note_on": on}, t=float(tv), note_id=nid)

    while True:
        tok = parser.parse_token()
        if tok is None:
            break
        if tok.kind == "word" and tok.word == "start":
            t = F32(0.0)
            for ev in events:
                ev.clear()
        elif tok.kind == "word" and tok.word == "rate":
            rate = F32(parser.require_number())
        elif tok.kind == "word" and tok.word == "tempo":
            tempo = F32(parser.require_number())
        elif tok.kind == "notes":
            slot_start = [len(ev) for ev in events]
            for col, cell in enumerate(tok.notes):
                inst = col_to_instrument[col]
                if cell.kind == "freq":
                    if column_last_note[col] is not None:
                        freq0, id0 = column_last_note[col]
                        events[inst].append(make(t, id0, freq0, False))
                    events[inst].append(make(t, next_id, cell.freq, True))
                    column_last_note[col] = (cell.freq, next_id)
                    next_id += 1
                elif cell.kind == "off":
                    if column_last_note[col] is not None:
                        freq0, id0 = column_last_note[col]
                        events[inst].append(make(t, id0, freq0, False))
                        column_last_note[col] = None
            t = F32(t + F32(F32(note_duration) / F32(rate * tempo)))
            # sort this timeslot's events by note id: offs before ons
            for inst, ev in enumerate(events):
                s = slot_start[inst]
                ev[s:] = sorted(ev[s:], key=lambda e: e.note_id)
        else:
            raise SongParseError(parser.line_index, f"unexpected token {tok.kind}")

    return events
