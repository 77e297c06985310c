"""Incremental live planners: O(events) host work per block, not O(session).

The offline planners (instrument.plan) walk every segment since t=0; the
LiveSession originally re-ran them on each event block, so host cost grew
linearly with session length (~10 us/segment — a long jam session would
blow the 21 ms real-time budget). These planners keep the walk state
*carried* instead:

- phase (ops.oscillators.plan_phase_segments twin): the only cross-segment
  state is the accumulated u32 phase `c`; appending a segment is O(1).
- painter/envelope (ops.control.EnvelopeWalkStream): the ADSR walk state is
  (stage, painter t/last/start). Closed segments feed the committed stream
  once; the open (still-sounding) segment is painted provisionally up to
  the window end each block from a snapshot, then rewound — deterministic
  f32 accumulation makes successive provisional paints byte-stable.
- gate / active_from: per-segment local, appended at event time.

Window extraction replaces graph-wide slicing with per-voice cursors that
only move forward, so render_block's host cost is O(slot_capacity) and
independent of session length. Outputs are bit-identical to the full
re-plan path (tests/test_liveplan.py).

A copy of zang_tpu/host/liveplan.py (the port imports nothing of zang_tpu).
"""

from typing import Callable, Dict, List, Optional

import numpy as np

from ..ops.control import SHAPE_CONST, EnvelopeWalkStream, Seg
from ..ops import control

F32 = np.float32

_NEVER = np.int32(2**31 - 1)

# painter program value names, matching ops.control.painter_program
_PAINTER_VALS = ("a", "b", "t_step", "t0", "shape", "seg_start")


# degrade switch for over-capacity windows: when True, window extraction
# drops the OLDEST segments of an overflowing window instead of raising
# (one transiently mis-rendered block; the reference similarly degrades by
# dropping events past its 32-impulse cap, notes.zig:108-118). Set
# temporarily by LiveSession.render_block once slot growth hits its cap.
TRUNCATE_OVERFLOW = False


def _window_lo(i: int, j: int, KP: int) -> int:
    """First segment index to keep for a window spanning segs [i..j]."""
    count = j - i + 1
    if count <= KP:
        return i
    if TRUNCATE_OVERFLOW:
        return j - KP + 1
    raise RuntimeError(
        f"live block needs {count} slots > slot_capacity={KP}; "
        "raise slot_capacity"
    )


def advance_cursor(starts_at, length: int, cursor: int, f0: int) -> int:
    """Forward-only covering-segment search: starts_at(i) is the i-th start.
    Returns the last index whose start <= f0 (amortized O(1) per window)."""
    i = min(cursor, length - 1) if length else 0
    while i + 1 < length and starts_at(i + 1) <= f0:
        i += 1
    return i


def painter_segs_window(segs, cursor: int, f0: int, f1: int, KP: int,
                        starts, vals, v: int):
    """Fill row v of a painter window ({starts + _PAINTER_VALS} [V, KP])
    from a Seg list. Returns the advanced cursor."""
    i = advance_cursor(lambda n: segs[n][0], len(segs), cursor, f0)
    j = i
    while j + 1 < len(segs) and segs[j + 1][0] < f1:
        j += 1
    i = _window_lo(i, j, KP)
    count = j - i + 1
    for n in range(KP):
        s, a, b, t_step, t0, shape = segs[min(i + n, j)]
        if n < count:
            starts[v, n] = s
        vals["a"][v, n] = a
        vals["b"][v, n] = b
        vals["t_step"][v, n] = t_step
        vals["t0"][v, n] = t0
        vals["shape"][v, n] = shape
        vals["seg_start"][v, n] = s
    return i


def new_painter_window(V: int, KP: int, f1: int):
    starts = np.full((V, KP), f1, dtype=np.int32)
    vals = {
        "a": np.zeros((V, KP), np.float32),
        "b": np.zeros((V, KP), np.float32),
        "t_step": np.zeros((V, KP), np.float32),
        "t0": np.zeros((V, KP), np.float32),
        "shape": np.zeros((V, KP), np.int32),
        "seg_start": np.zeros((V, KP), np.int32),
    }
    return starts, vals


def columns_window(starts_lists, value_lists, dtypes, cursors,
                   f0: int, f1: int, KP: int):
    """Generic per-voice segment-column window: {starts [V,KP] i32,
    name: [V,KP]} with repeat-last fill (zero pconst deltas). cursors is
    mutated in place."""
    V = len(starts_lists)
    out_starts = np.full((V, KP), f1, dtype=np.int32)
    out = {
        name: np.zeros((V, KP), dtypes.get(name, np.float32))
        for name in value_lists
    }
    for v in range(V):
        starts = starts_lists[v]
        if not starts:
            continue
        i = advance_cursor(starts.__getitem__, len(starts), cursors[v], f0)
        j = i
        while j + 1 < len(starts) and starts[j + 1] < f1:
            j += 1
        i = _window_lo(i, j, KP)
        cursors[v] = i
        count = j - i + 1
        for n in range(KP):
            k = min(i + n, j)
            if n < count:
                out_starts[v, n] = starts[k]
            for name in value_lists:
                out[name][v, n] = value_lists[name][v][k]
    return {"starts": out_starts, **out}


class _PainterSegWindow:
    """Shared window extraction over per-voice painter segment lists.

    Subclasses maintain `self.segs(v)` (list of Seg, append-mostly) —
    windows move strictly forward, so a per-voice cursor finds the covering
    segment in amortized O(1)."""

    def __init__(self, V: int) -> None:
        self.V = V
        self._cursor = [0] * V

    def _voice_segs(self, v: int, f1: int) -> List[Seg]:
        raise NotImplementedError

    def window(self, f0: int, f1: int, KP: int) -> Dict[str, np.ndarray]:
        starts, vals = new_painter_window(self.V, KP, f1)
        for v in range(self.V):
            segs = self._voice_segs(v, f1)
            self._cursor[v] = painter_segs_window(
                segs, self._cursor[v], f0, f1, KP, starts, vals, v)
        return {"starts": starts, **vals}


class IncEnvelope(_PainterSegWindow):
    """Incremental twin of ops.control.compile_envelope + painter_program."""

    def __init__(self, V: int, sample_rate: float,
                 env_params_fn: Callable) -> None:
        super().__init__(V)
        self.streams = [EnvelopeWalkStream(sample_rate, env_params_fn)
                        for _ in range(V)]
        self.open: List[Optional[tuple]] = [None] * V  # (start, reset, params)

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        prev = self.open[v]
        if prev is not None:
            s0, r0, p0 = prev
            self.streams[v].feed(s0, start, r0, p0)
        self.open[v] = (start, reset, params)

    def _voice_segs(self, v: int, f1: int) -> List[Seg]:
        st = self.streams[v]
        prev = self.open[v]
        if prev is None:
            return st.segs
        snap = st.snapshot()
        s0, r0, p0 = prev
        st.feed(s0, max(f1, s0 + 1), r0, p0)  # provisional paint to window end
        segs = list(st.segs)
        st.restore(snap)
        return segs


class IncPortamento(_PainterSegWindow):
    """Incremental twin of ops.control.compile_portamento: the walk carries
    the current glide position, so each new goal re-targets from wherever
    the value is now (Portamento.zig semantics). Used both for note-event
    driven portamento and for continuous-controller channels (the mouse
    example's ratio/mult paths, examples/example_mouse.zig)."""

    def __init__(self, V: int, sample_rate: float,
                 porta_params_fn: Callable) -> None:
        super().__init__(V)
        self.streams = [control.PortamentoWalkStream(sample_rate,
                                                     porta_params_fn)
                        for _ in range(V)]
        self.open: List[Optional[tuple]] = [None] * V  # (start, reset, params)

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        prev = self.open[v]
        if prev is not None:
            s0, r0, p0 = prev
            self.streams[v].feed(s0, start, r0, p0)
        self.open[v] = (start, reset, params)

    def _voice_segs(self, v: int, f1: int) -> List[Seg]:
        st = self.streams[v]
        prev = self.open[v]
        if prev is None:
            return st.segs
        snap = st.snapshot()
        s0, r0, p0 = prev
        st.feed(s0, max(f1, s0 + 1), r0, p0)  # provisional paint to window end
        segs = list(st.segs)
        st.restore(snap)
        return segs


class IncGate(_PainterSegWindow):
    """Incremental twin of ops.control.compile_gate (value is segment-local,
    so segments commit at event time; no provisional paint needed)."""

    def __init__(self, V: int, gate_fn=None) -> None:
        super().__init__(V)
        self.gate_fn = gate_fn or (lambda p: bool(p["note_on"]))
        self._segs: List[List[Seg]] = [
            [(0, 0.0, 0.0, 0.0, 0.0, SHAPE_CONST)] for _ in range(V)
        ]

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        val = 1.0 if self.gate_fn(params) else 0.0
        if self._segs[v][-1][1] == val:
            return
        self._segs[v].append((start, val, 0.0, 0.0, 0.0, SHAPE_CONST))

    def _voice_segs(self, v: int, f1: int) -> List[Seg]:
        return self._segs[v]


class IncPhase:
    """Incremental twin of ops.oscillators.plan_phase_segments: per-segment
    u32 phase coefficients; the only carry is the accumulated phase `c`.

    extra_fns: {name: fn(params) -> np.float32} — extra per-segment values
    packed into the same window (e.g. NiceInstrument's filter cutoff)."""

    def __init__(self, V: int, sample_rate: float, freq_fn,
                 guard_div8: bool = False,
                 extra_fns: Optional[Dict[str, Callable]] = None) -> None:
        self.V = V
        self.freq_fn = freq_fn
        self.guard = guard_div8
        self.extra_fns = extra_fns or {}
        self.sr = F32(sample_rate)
        self.srbase = F32(F32(4294967296.0) / F32(sample_rate))
        self.starts: List[List[int]] = [[] for _ in range(V)]
        self.vals: Dict[str, List[List]] = {
            name: [[] for _ in range(V)]
            for name in ("ifreq", "A", "valid", *self.extra_fns)
        }
        self.c = [np.uint32(0)] * V  # phase at the open segment's start
        self.open: List[Optional[tuple]] = [None] * V  # (start, inc)
        self._cursor = [0] * V

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        with np.errstate(over="ignore"):
            prev = self.open[v]
            if prev is not None:
                s0, inc0 = prev
                self.c[v] = np.uint32(
                    self.c[v] + np.uint32(np.uint32(start - s0) * inc0)
                )
            freq = F32(self.freq_fn(params))
            scaled = F32(self.srbase * freq)
            mag = np.abs(scaled).astype(np.uint32)
            inc = mag if scaled >= 0 else np.uint32(np.uint32(0) - mag)
            ok = True
            if self.guard:
                ok = bool((freq >= 0) & (freq <= F32(self.sr / F32(8.0))))
                if not ok:
                    inc = np.uint32(0)
            A = np.uint32(self.c[v] - np.uint32(np.uint32(start) * inc))
        self.starts[v].append(int(start))
        self.vals["ifreq"][v].append(inc)
        self.vals["A"][v].append(A)
        self.vals["valid"][v].append(F32(1.0 if ok else 0.0))
        for name, fn in self.extra_fns.items():
            self.vals[name][v].append(F32(fn(params)))
        self.open[v] = (start, inc)

    def window(self, f0: int, f1: int, KP: int) -> Dict[str, np.ndarray]:
        dtypes = {"ifreq": np.uint32, "A": np.uint32, "valid": np.float32}
        return columns_window(self.starts, self.vals, dtypes, self._cursor,
                              f0, f1, KP)


class IncValues:
    """Incremental per-voice value columns: one segment per event carrying
    {name: fn(params)} values with repeat-last window fill — the planner
    twin of a plan() that lays raw per-note values (e.g. FMSynthInstrument's
    freqs program) into a SegProgram."""

    def __init__(self, V: int, fns: Dict[str, Callable],
                 dtypes: Optional[Dict[str, object]] = None) -> None:
        self.V = V
        self.fns = dict(fns)
        self.dtypes = dict(dtypes or {})
        self.starts: List[List[int]] = [[] for _ in range(V)]
        self.vals: Dict[str, List[List]] = {
            name: [[] for _ in range(V)] for name in self.fns
        }
        self._cursor = [0] * V

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        self.starts[v].append(int(start))
        for name, fn in self.fns.items():
            self.vals[name][v].append(fn(params))

    def window(self, f0: int, f1: int, KP: int) -> Dict[str, np.ndarray]:
        return columns_window(self.starts, self.vals, self.dtypes,
                              self._cursor, f0, f1, KP)


class IncActiveFrom:
    """Incremental twin of core.timeline.active_from: first event frame per
    voice (never-active voices stay at i32 max, masking everything)."""

    def __init__(self, V: int) -> None:
        self.arr = np.full((V,), _NEVER, dtype=np.int32)

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        if self.arr[v] == _NEVER:
            self.arr[v] = np.int32(start)

    def window(self, f0: int, f1: int, KP: int) -> np.ndarray:
        return self.arr.copy()


class LivePlanKit:
    """A program-dict of incremental planners, mirroring an instrument's
    plan() structure. static: extra non-planned leaves (e.g. a scalar
    cutoff) passed through each window.

    controllers: {controller_name: {channel_name: planner}} — channels
    driven by a continuous-controller stream (LiveSession.push_controller,
    the reference's mouseEvent path) instead of note events. Controller
    planners appear in the window like any other channel but only receive
    extend_controller() events."""

    def __init__(self, planners: Dict[str, object],
                 static: Optional[Dict[str, object]] = None,
                 controllers: Optional[Dict[str, Dict[str, object]]] = None,
                 ) -> None:
        self.planners = planners
        self.static = static or {}
        self.controllers = controllers or {}

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        for p in self.planners.values():
            p.extend(v, start, reset, params)

    def extend_controller(self, name: str, frame: int, value: float) -> None:
        """One controller move: re-target every channel bound to `name`
        (reset=True — each move restarts the glide toward the new value
        from the current position, the mouse example's event train)."""
        for p in self.controllers[name].values():
            p.extend(0, frame, True, {"value": value})

    def window(self, f0: int, f1: int, KP: int) -> dict:
        prog = {name: p.window(f0, f1, KP)
                for name, p in self.planners.items()}
        for chans in self.controllers.values():
            for name, p in chans.items():
                prog[name] = p.window(f0, f1, KP)
        prog.update(self.static)
        return prog
