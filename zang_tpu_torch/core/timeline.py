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

import itertools
import operator
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


class PartColumns:
    """A part's timelines as flat per-segment columns, gathered in one pass
    over the part: what the instruments' planners compute on, over every
    voice at once.

    Segment j of the part is voice v's segment k for offsets[v] <= j =
    offsets[v] + k < offsets[v + 1]. pad(col) lays a column out as the
    planners' [V, K] arrays, each voice's last value repeated into its
    padding and 0 for a voice with no segments."""

    def __init__(self, timelines: List[SubvoiceTimeline]) -> None:
        self.total = timelines[0].total if timelines else 0
        self.num_voices = V = len(timelines)
        self.counts = np.fromiter((len(tl.starts) for tl in timelines), np.int64, V)
        self.offsets = np.zeros(V + 1, np.int64)
        np.cumsum(self.counts, out=self.offsets[1:])
        self.K = max(1, int(self.counts.max(initial=0)))
        self.starts = np.concatenate(
            [np.asarray(tl.starts, np.int64) for tl in timelines] + [np.zeros(0, np.int64)])
        self.resets = np.concatenate(
            [np.asarray(tl.resets, bool) for tl in timelines] + [np.zeros(0, bool)])
        self.params = list(itertools.chain.from_iterable(tl.params for tl in timelines))
        N = len(self.starts)
        # [V, K] -> the segment it repeats (N, past the columns, for none)
        k = np.arange(self.K)
        idx = self.offsets[:-1, None] + np.minimum(k, self.counts[:, None] - 1)
        self._pad_index = np.where(self.counts[:, None] > 0, idx, N)
        self._real = k < self.counts[:, None]
        self._f32 = {}

    def segments(self):
        """(voice, k, params) of every segment, in column order."""
        for v, (lo, hi) in enumerate(zip(self.offsets[:-1].tolist(), self.offsets[1:].tolist())):
            for k in range(hi - lo):
                yield v, k, self.params[lo + k]

    def pad(self, col: np.ndarray) -> np.ndarray:
        """A column [N] as [V, K] (see the class)."""
        return np.append(col, np.zeros(1, col.dtype))[self._pad_index]

    def padded_starts(self) -> np.ndarray:
        """[V, K] int64 segment starts, total in each voice's padding."""
        return np.where(self._real, self.pad(self.starts), self.total)

    def ends(self) -> np.ndarray:
        """[N] each segment's end: the next start of its voice, or total."""
        ends = np.empty_like(self.starts)
        ends[:-1] = self.starts[1:]
        ends[self.offsets[1:][self.counts > 0] - 1] = self.total
        return ends

    def per_segment(self, arr) -> np.ndarray:
        """The [V, >= K] array's value at each segment, [N]."""
        v = np.repeat(np.arange(self.num_voices), self.counts)
        return np.asarray(arr)[v, np.arange(len(self.starts)) - self.offsets[v]]

    def column(self, key, dtype) -> np.ndarray:
        """params[key] of every segment as a [N] column of dtype."""
        return np.fromiter(map(operator.itemgetter(key), self.params), dtype, len(self.params))

    def param_f32(self, fn) -> np.ndarray:
        """fn(params) of every segment as f32 [N]. A function that carries
        `array_form` (fn.array_form(columns) -> the same f32 values) is
        computed over the columns; any other is called a segment."""
        got = self._f32.get(fn)
        if got is None:
            form = getattr(fn, "array_form", None)
            got = (form(self) if form is not None
                   else np.array([fn(p) for p in self.params], np.float32))
            self._f32[fn] = got
        return got


def part_columns(timelines) -> PartColumns:
    """timelines as a PartColumns (itself if it is one already)."""
    return timelines if isinstance(timelines, PartColumns) else PartColumns(timelines)


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
