"""Two-row musical keyboard map (examples/common.zig:16-84).

Maps typing-keyboard characters to relative note frequencies (multiply by
your a4). Bottom two keyboard rows span b2..f4; the top two rows span
c4..g5 (overlapping). Bindings are ordered lowest to highest frequency —
the arpeggiator cycles in this order. SDL keycodes are replaced by the key
characters ('shift_l'/'shift_r' for the two shifts).

A copy of zang_tpu/host/keyboard.py (the port imports nothing of zang_tpu).
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..core import twelve_tet as tt


@dataclass(frozen=True)
class KeyBinding:
    row: int
    key: str
    rel_freq: float


def _row0(key: str, note: str, octave: int) -> KeyBinding:
    return KeyBinding(0, key, tt.note_freq(note, octave))


def _row1(key: str, note: str, octave: int) -> KeyBinding:
    return KeyBinding(1, key, tt.note_freq(note, octave))


KEY_BINDINGS: List[KeyBinding] = [
    # bottom two rows: one octave b2..f4
    _row0("shift_l", "b", 2),
    _row0("z", "c", 3), _row0("s", "cs", 3), _row0("x", "d", 3),
    _row0("d", "ds", 3), _row0("c", "e", 3), _row0("v", "f", 3),
    _row0("g", "fs", 3), _row0("b", "g", 3), _row0("h", "gs", 3),
    _row0("n", "a", 3), _row0("j", "as", 3), _row0("m", "b", 3),
    _row0(",", "c", 4), _row0("l", "cs", 4), _row0(".", "d", 4),
    _row0(";", "ds", 4), _row0("/", "e", 4), _row0("shift_r", "f", 4),
    # top two rows: one octave up, overlapping
    _row1("q", "c", 4), _row1("2", "cs", 4), _row1("w", "d", 4),
    _row1("3", "ds", 4), _row1("e", "e", 4), _row1("r", "f", 4),
    _row1("5", "fs", 4), _row1("t", "g", 4), _row1("6", "gs", 4),
    _row1("y", "a", 4), _row1("7", "as", 4), _row1("u", "b", 4),
    _row1("i", "c", 5), _row1("9", "cs", 5), _row1("o", "d", 5),
    _row1("0", "ds", 5), _row1("p", "e", 5), _row1("[", "f", 5),
    _row1("=", "fs", 5), _row1("]", "g", 5),
]


def get_key_rel_freq(key: str) -> Optional[float]:
    """common.zig getKeyRelFreq: any-row lookup."""
    for kb in KEY_BINDINGS:
        if kb.key == key:
            return kb.rel_freq
    return None


def get_key_rel_freq_from_row(row: int, key: str) -> Optional[float]:
    """common.zig getKeyRelFreqFromRow: row-restricted lookup."""
    for kb in KEY_BINDINGS:
        if kb.row == row and kb.key == key:
            return kb.rel_freq
    return None


def keys_to_song(presses: List[Tuple[float, str, bool]], a4: float = 440.0):
    """Convert scripted (time, key, down) presses into SongEvents, with the
    monophonic-per-key id pairing the SDL host examples use."""
    from ..core.notes import SongEvent

    song = []
    held = {}
    next_id = 1
    for t, key, down in presses:
        rel = get_key_rel_freq(key)
        if rel is None:
            continue
        freq = a4 * rel
        if down:
            held[key] = next_id
            song.append(SongEvent({"freq": freq, "note_on": True}, t=t,
                                  note_id=next_id))
            next_id += 1
        elif key in held:
            song.append(SongEvent({"freq": freq, "note_on": False}, t=t,
                                  note_id=held.pop(key)))
    song.sort(key=lambda e: (e.t, e.note_id))
    return song
