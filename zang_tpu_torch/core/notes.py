"""Song events (host side; src/zang/notes.zig).

Params are plain dicts; the event compiler (core/native.py) reads
params["note_on"], the only place the core looks at note_on, mirroring the
reference (notes.zig:29-35).

The event type of zang_tpu/core/notes.py: the port keeps its own host core
and imports nothing of zang_tpu. The tracker and dispatcher that consume
these events run in the native compiler.
"""

from dataclasses import dataclass
from typing import Any, Dict

Params = Dict[str, Any]


@dataclass(frozen=True)
class SongEvent:
    """A canned song note event at time t seconds (notes.zig:130-136)."""

    params: Params
    t: float
    note_id: int
