"""Note timeline compiler: events -> per-subvoice segment tables.

The reference's event pipeline (NoteTracker block consumption,
PolyphonyDispatcher slot routing, Trigger span splitting — SURVEY.md §3.2)
runs over the full render duration on the host in the native C++ compiler
(core/native.py), which flattens each subvoice's note spans into a compact
segment table the device consumes via searchsorted gathers. "Events become
data": all timing/stealing/carry-over semantics are decided here,
bit-identically to the reference, because the tracker clock is float32.

The types and the native entry of zang_tpu/core/timeline.py: the port
keeps its own host core and imports nothing of zang_tpu.
"""

from dataclasses import dataclass
from typing import List

import numpy as np

from ..trace import span
from . import native
from .notes import SongEvent


@dataclass
class SubvoiceTimeline:
    """One subvoice's note segments over [0, total).

    Segment k covers [starts[k], starts[k+1]) (last ends at total).
    Before starts[0] the module is never painted (inactive).
    resets[k] is the reference's note_id_changed flag at segment start.
    """

    starts: np.ndarray  # int64 [K], strictly increasing
    resets: np.ndarray  # bool [K]
    params: List[dict]  # per-segment note params
    total: int

    @property
    def first_active(self) -> int:
        return int(self.starts[0]) if len(self.starts) else self.total

    def param_f32(self, key_or_fn) -> np.ndarray:
        """Per-segment param values as f32 [K]."""
        fn = key_or_fn if callable(key_or_fn) else (lambda p: p[key_or_fn])
        return np.array([fn(p) for p in self.params], dtype=np.float32)


def compile_timelines(
    song: List[SongEvent],
    polyphony: int,
    sample_rate: float,
    total_frames: int,
    block_size: int = 1024,
) -> List[SubvoiceTimeline]:
    """Run tracker -> dispatcher -> per-subvoice triggers over the whole song
    in the native compiler.

    Returns one SubvoiceTimeline per polyphony slot. Block size matters: the
    tracker quantizes event times per block with f32 arithmetic exactly like
    the reference host (AUDIO_BUFFER_SIZE=1024 in all examples). Params must
    be hashable dicts (the compiler groups equal ones); the compiler's
    failures raise.
    """
    with span("plan.timelines"):
        return native.compile_timelines_native(song, polyphony, sample_rate,
                                               total_frames, block_size)


def active_from(timelines: List[SubvoiceTimeline]) -> np.ndarray:
    """[V] first active frame per subvoice (total if never active)."""
    return np.array([tl.first_active for tl in timelines], dtype=np.int32)
