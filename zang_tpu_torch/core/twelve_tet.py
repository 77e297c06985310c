"""12-tone equal temperament pitch table.

Relative frequencies (multiply by your chosen a4, e.g. 440.0).
Reference: src/zang-12tet.zig:9-163 — constants c0..b8 built from
semitone = 2^(1/12), note n semitones away from a4.

Computed in float32 to match the reference's f32 constants.

A copy of zang_tpu/core/twelve_tet.py: the port keeps its own host core and
imports nothing of zang_tpu.
"""

import numpy as np

_NAMES = [
    ("c", 0),
    ("cs", 1),
    ("db", 1),
    ("d", 2),
    ("ds", 3),
    ("eb", 3),
    ("e", 4),
    ("f", 5),
    ("fs", 6),
    ("gb", 6),
    ("g", 7),
    ("gs", 8),
    ("ab", 8),
    ("a", 9),
    ("as", 10),
    ("bb", 10),
    ("b", 11),
]

_SEMITONE = np.float32(2.0) ** np.float32(1.0 / 12.0)


def rel_freq(semitones_from_a4: int) -> float:
    """Relative frequency of the note `semitones_from_a4` away from a4."""
    return float(np.float32(_SEMITONE) ** np.float32(semitones_from_a4))


def note_freq(name: str, octave: int, a4: float = 1.0) -> float:
    """Frequency of e.g. note_freq('cs', 4). a4 defaults to relative (1.0)."""
    for n, semi in _NAMES:
        if n == name:
            return a4 * rel_freq(octave * 12 - 57 + semi)
    raise KeyError(name)


def _build():
    g = globals()
    for octave in range(9):
        for name, semi in _NAMES:
            g[f"{name}{octave}"] = rel_freq(octave * 12 - 57 + semi)


_build()
