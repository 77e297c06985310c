"""Incremental live planning for zangscript instruments.

ScriptInstrument.plan re-walks the whole session's bytecode-derived plan on
every event block (O(session length) — and track-call simulation walks every
1024-sample block since t=0). This module carries the walk state instead,
the DSL counterpart of host/liveplan.py:

- The bytecode IR is walked once at construction (empty timelines) to fix
  the device IR, state specs, and the deterministic site/column naming.
- Each live block runs two cheap walks over ONLY the new/open segments:
  a COMMIT walk (newly closed segments feed carried site state permanently;
  curve/track sites also commit the open segment's prefix up to the last
  1024 boundary so held notes don't grow provisional work), then a
  PROVISIONAL walk (open segments painted to the window end from snapshots,
  rolled back after the window is built).
- Carried state per site kind: painter walks (ops.control *WalkStream),
  curve walks (CurveWalkStream), u32 phase accumulators (osc seg mode), and
  tracker/trigger pairs for track calls (the _simulate_track loop, one
  outer-segment range at a time).
- Per-scale storage holds committed segment starts + column values (note
  params, float arithmetic results, osc coefficients); windows are built
  with forward-only cursors (host/liveplan.columns_window).

Bit-exact against the full re-plan path (tests/test_scriptlive.py).

A copy of zang_tpu/script/liveplan.py (the port imports nothing of zang_tpu).
"""

from typing import Dict, List, Optional

import numpy as np

from ..core.notes import NoteTracker, SongEvent
from ..core.span import Span
from ..core.trigger import Trigger
from ..host.liveplan import (
    _NEVER,
    columns_window,
    new_painter_window,
    painter_segs_window,
)
from ..ops.control import (
    CurveWalkStream,
    EnvelopeWalkStream,
    GateWalkStream,
    PortamentoWalkStream,
)

F32 = np.float32

_TRACK_BLOCK = 1024  # the generated-Zig track protocol block (codegen_zig.zig)


# -- per-scale segment/column storage ----------------------------------------


class _ScaleState:
    """Committed closed segments + one open segment per voice, plus the
    per-segment column values harvested from walks."""

    def __init__(self, V: int, initial_open=None) -> None:
        self.V = V
        self.starts: List[List[int]] = [[] for _ in range(V)]
        self.cols: Dict[str, List[List]] = {}
        self.col_dtypes: Dict[str, object] = {}
        self.open: List[Optional[tuple]] = [
            tuple(initial_open) if initial_open else None for _ in range(V)
        ]
        self.cursors = [0] * V
        self.pending: List[List[tuple]] = [[] for _ in range(V)]

    def register_col(self, name: str, dtype) -> None:
        if name not in self.cols:
            self.cols[name] = [[] for _ in range(self.V)]
            self.col_dtypes[name] = dtype

    def snapshot(self):
        return (
            [len(s) for s in self.starts],
            {name: [len(x) for x in lists] for name, lists in self.cols.items()},
            list(self.open),
            [list(p) for p in self.pending],
        )

    def restore(self, snap) -> None:
        slens, clens, self.open, pend = snap
        self.pending = pend
        for v, n in enumerate(slens):
            del self.starts[v][n:]
        for name, lens in clens.items():
            for v, n in enumerate(lens):
                del self.cols[name][v][n:]

    def make_entries(self, mode: str, f1c: int, floor_f1: int):
        """Consume pending segments -> per-voice walk entries.

        Entry: (v, k, s, e, reset, params, partial). k indexes the voice's
        mini timeline = closed chain + open. COMMIT: closed entries are
        final; the open gets a `partial` entry (curve/track prefix commit
        only). PROVISIONAL: the open gets a full entry painted to f1c."""
        entries = []
        minis = []
        for v in range(self.V):
            segs = self.pending[v]
            self.pending[v] = []
            closed = []
            cur = self.open[v]
            for seg in segs:
                if cur is not None:
                    closed.append((cur[0], seg[0], cur[1], cur[2]))
                cur = seg
            self.open[v] = cur
            mini = [(s, r, p) for (s, _e, r, p) in closed]
            for k, (s, e, r, p) in enumerate(closed):
                entries.append((v, k, s, e, r, p, False))
            if cur is not None:
                k = len(mini)
                mini.append((cur[0], cur[1], cur[2]))
                if mode == "prov":
                    entries.append((v, k, cur[0], f1c, cur[1], cur[2], False))
                else:  # commit/init: open prefix for curve/track only
                    entries.append((v, k, cur[0], floor_f1, cur[1], cur[2], True))
            minis.append(mini)
        return entries, minis


# -- carried site state --------------------------------------------------------


_PAINTER_STREAMS = {
    "envelope": lambda sr: EnvelopeWalkStream(sr, lambda k, d: d),
    "gate": lambda sr: GateWalkStream(lambda d: bool(d["note_on"])),
    "portamento": lambda sr: PortamentoWalkStream(sr, lambda k, d: d),
}


class _PainterSite:
    def __init__(self, V: int, sr: float, kind: str) -> None:
        self.streams = [_PAINTER_STREAMS[kind](sr) for _ in range(V)]
        self.cursors = [0] * V

    def snapshot(self):
        return [st.snapshot() for st in self.streams]

    def restore(self, snap):
        for st, sn in zip(self.streams, snap):
            st.restore(sn)


class _CurveSite:
    def __init__(self, V: int, sr: float, points, fn_label: str) -> None:
        self.streams = [
            CurveWalkStream(points, fn_label, sr, _TRACK_BLOCK)
            for _ in range(V)
        ]
        self.cursors = [0] * V

    def snapshot(self):
        return [st.snapshot() for st in self.streams]

    def restore(self, snap):
        for st, sn in zip(self.streams, snap):
            st.restore(sn)


class _OscSite:
    def __init__(self, V: int) -> None:
        self.c = [np.uint32(0)] * V

    def snapshot(self):
        return list(self.c)

    def restore(self, snap):
        self.c = snap


class _TrackVoiceStream:
    """Streaming _simulate_track (torch_backend.py): carried tracker/trigger,
    fed one outer-segment range at a time; `pos` lets a held outer segment
    commit block-prefix by block-prefix."""

    def __init__(self, song: List[SongEvent]) -> None:
        self.tracker = NoteTracker(song)
        self.trigger = Trigger()
        self.pos: Optional[int] = None
        self.last_params: Optional[dict] = {"_active": 0.0}  # matches the
        # initial inactive segment the scale is seeded with

    def snapshot(self):
        return (self.tracker.next_song_event, self.tracker.t,
                self.trigger.note, self.pos, self.last_params)

    def restore(self, snap):
        (self.tracker.next_song_event, self.tracker.t,
         self.trigger.note, self.pos, self.last_params) = snap

    def feed_partial(self, sr: float, s: int, e: int, reset: bool,
                     speed: float, note_on: Optional[bool]) -> List[tuple]:
        start = s if self.pos is None else max(self.pos, s)
        if e <= start:
            return []
        outer_reset = reset and (note_on if note_on is not None else True)
        eff_sr = float(F32(F32(sr) / F32(speed)))
        emitted: List[tuple] = []

        def emit(abs_start, reset_flag, params):
            if not reset_flag and self.last_params == params:
                return
            emitted.append((abs_start, reset_flag, params))
            self.last_params = params

        pos = start
        while pos < e:
            span_end = min(e, (pos // _TRACK_BLOCK + 1) * _TRACK_BLOCK)
            first_span = pos == s
            if first_span and outer_reset:
                self.tracker.reset()
                self.trigger.reset()
            n = span_end - pos
            iap = self.tracker.consume(eff_sr, Span(0, n))
            covered_to = pos
            for r in self.trigger.iterate(Span(0, n), iap):
                abs_start = pos + r.span.start
                if abs_start > covered_to:
                    emit(covered_to, False, {"_active": 0.0})
                new_note = (first_span and outer_reset) or r.note_id_changed
                emit(abs_start, new_note, dict(r.params))
                covered_to = pos + r.span.end
            if covered_to < span_end:
                emit(covered_to, False, {"_active": 0.0})
            pos = span_end
        self.pos = e
        return emitted


class _TrackSite:
    def __init__(self, V: int, track, note_values) -> None:
        from .torch_backend import track_note_events

        song = track_note_events(track, note_values)
        self.streams = [_TrackVoiceStream(song) for _ in range(V)]

    def snapshot(self):
        return [st.snapshot() for st in self.streams]

    def restore(self, snap):
        for st, sn in zip(self.streams, snap):
            st.restore(sn)


# -- the planner ----------------------------------------------------------------


class ScriptLivePlanner:
    """LiveSession planner for ScriptInstrument: extend(v, start, reset,
    params) buffers events; window(f0, f1, KP) runs the commit + provisional
    walks and returns the device program windows."""

    def __init__(self, inst, polyphony: int, sample_rate: float) -> None:
        self.inst = inst
        self.V = polyphony
        self.sr = float(sample_rate)
        self.scales: Dict[str, _ScaleState] = {"note": _ScaleState(polyphony)}
        self.scale_order: List[str] = ["note"]
        self.painter_sites: Dict[str, object] = {}  # painter + curve sites
        self.site_scale: Dict[str, str] = {}
        self.osc_sites: Dict[str, _OscSite] = {}
        self.track_sites: Dict[str, _TrackSite] = {}
        self.active_from = np.full((polyphony,), _NEVER, dtype=np.int32)
        self._mode = "init"
        self._f1c = 0
        self._walk("init", 0, 0)  # fixes inst._ir/_state_specs + site registry

    # -- events ---------------------------------------------------------------

    def extend(self, v: int, start: int, reset: bool, params: dict) -> None:
        self.scales["note"].pending[v].append((int(start), bool(reset),
                                               dict(params)))
        if self.active_from[v] == _NEVER:
            self.active_from[v] = np.int32(start)

    # -- walks ------------------------------------------------------------------

    def _walk(self, mode: str, f1c: int, floor_f1: int) -> None:
        from .torch_backend import _Planner, _make_scale
        from ..core.timeline import SubvoiceTimeline

        self._mode = mode
        self._f1c = f1c
        self._floor_f1 = floor_f1
        self._walk_entries: Dict[str, list] = {}
        self._walk_scales: List[str] = []

        note = self.scales["note"]
        entries, minis = note.make_entries(mode, f1c, floor_f1)
        self._walk_entries["note"] = entries
        self._walk_scales.append("note")

        def mk_tls(minis_v):
            out = []
            for mini in minis_v:
                out.append(SubvoiceTimeline(
                    starts=np.array([s for s, _, _ in mini], dtype=np.int64),
                    resets=np.array([r for _, r, _ in mini], dtype=bool),
                    params=[p for _, _, p in mini],
                    total=max(f1c, 1),
                ))
            return out

        self._mk_tls = mk_tls
        tls = mk_tls(minis)
        p = _Planner(self.inst.compiled, self.sr, self.V, live=self)
        p.scales["note"] = _make_scale("note", tls)
        root_K = p.scales["note"].K
        bindings = self.inst.root_bindings(tls, root_K, self.sr)
        ir = p.inline_module(self.inst.module_index, bindings, "note")
        if mode == "init":
            self.inst._ir = ir
            self.inst._state_specs = p.state_specs
        # harvest the walk's column values into persistent storage
        for name in self._walk_scales:
            sc = self.scales[name]
            mini_scale = p.scales[name]
            for cname, arr in mini_scale.columns.items():
                if cname in self.osc_cols(name):
                    continue  # osc sites append their columns directly
                sc.register_col(cname, arr.dtype)
            for (v, k, s, _e, _r, _p, partial) in self._walk_entries[name]:
                if partial:
                    continue
                sc.starts[v].append(s)
                for cname, arr in mini_scale.columns.items():
                    if cname in self.osc_cols(name):
                        continue
                    sc.cols[cname][v].append(arr[v, k])

    def osc_cols(self, scale_name: str):
        return {
            f"{site}_{part}"
            for site, sname in self.site_scale.items()
            if sname == scale_name and site in self.osc_sites
            for part in ("ifreq", "A", "valid")
        }

    # -- backend hooks (called from torch_backend during walks) --------------------

    def painter_site(self, site: str, scale_name: str, kind: str, resolver):
        st = self.painter_sites.get(site)
        if st is None:
            st = self.painter_sites[site] = _PainterSite(self.V, self.sr, kind)
            self.site_scale[site] = scale_name
        for (v, k, s, e, reset, _params, partial) in self._walk_entries[scale_name]:
            if partial:
                continue
            st.streams[v].feed(s, e, reset, resolver(v, k))

    def curve_site(self, site: str, scale_name: str, points, fn_label: str):
        st = self.painter_sites.get(site)
        if st is None:
            st = self.painter_sites[site] = _CurveSite(self.V, self.sr,
                                                       points, fn_label)
            self.site_scale[site] = scale_name
        for (v, _k, s, e, reset, _params, _partial) in self._walk_entries[scale_name]:
            st.streams[v].feed_partial(s, e, reset)

    def osc_site(self, site: str, scale_name: str, freq_arr, guard: bool):
        st = self.osc_sites.get(site)
        sc = self.scales[scale_name]
        if st is None:
            st = self.osc_sites[site] = _OscSite(self.V)
            self.site_scale[site] = scale_name
            sc.register_col(f"{site}_ifreq", np.uint32)
            sc.register_col(f"{site}_A", np.uint32)
            sc.register_col(f"{site}_valid", np.float32)
        srbase = F32(F32(4294967296.0) / F32(self.sr))
        with np.errstate(over="ignore"):
            for (v, k, s, e, _reset, _params, partial) in self._walk_entries[scale_name]:
                if partial:
                    continue
                freq = F32(freq_arr[v, k])
                scaled = F32(srbase * freq)
                mag = np.abs(scaled).astype(np.uint32)
                inc = mag if scaled >= 0 else np.uint32(np.uint32(0) - mag)
                ok = True
                if guard:
                    ok = bool((freq >= 0)
                              & (freq <= F32(F32(self.sr) / F32(8.0))))
                    if not ok:
                        inc = np.uint32(0)
                A = np.uint32(st.c[v] - np.uint32(np.uint32(s) * inc))
                sc.cols[f"{site}_ifreq"][v].append(inc)
                sc.cols[f"{site}_A"][v].append(A)
                sc.cols[f"{site}_valid"][v].append(F32(1.0 if ok else 0.0))
                if self._mode == "commit":
                    st.c[v] = np.uint32(
                        st.c[v] + np.uint32(np.uint32(e - s) * inc))

    def track_site(self, site: str, scale_name: str, track, note_values,
                   speed_arr, note_on_arr):
        st = self.track_sites.get(site)
        if st is None:
            st = self.track_sites[site] = _TrackSite(self.V, track,
                                                     note_values)
            self.site_scale[site] = scale_name
            self.scales[site] = _ScaleState(
                self.V, initial_open=(0, False, {"_active": 0.0}))
            self.scale_order.append(site)
        sc = self.scales[site]
        for (v, k, s, e, reset, _params, _partial) in self._walk_entries[scale_name]:
            speed = float(speed_arr[v, k])
            non = bool(note_on_arr[v, k]) if note_on_arr is not None else None
            sc.pending[v].extend(
                st.streams[v].feed_partial(self.sr, s, e, reset, speed, non))
        entries, minis = sc.make_entries(self._mode, self._f1c, self._floor_f1)
        self._walk_entries[site] = entries
        self._walk_scales.append(site)
        return self._mk_tls(minis)

    # -- windows ------------------------------------------------------------------

    def _snapshot_all(self):
        return (
            {n: sc.snapshot() for n, sc in self.scales.items()},
            {n: st.snapshot() for n, st in self.painter_sites.items()},
            {n: st.snapshot() for n, st in self.osc_sites.items()},
            {n: st.snapshot() for n, st in self.track_sites.items()},
        )

    def _restore_all(self, snap):
        scales, painters, oscs, tracks = snap
        for n, sn in scales.items():
            self.scales[n].restore(sn)
        for n, sn in painters.items():
            self.painter_sites[n].restore(sn)
        for n, sn in oscs.items():
            self.osc_sites[n].restore(sn)
        for n, sn in tracks.items():
            self.track_sites[n].restore(sn)

    def window(self, f0: int, f1: int, KP: int) -> dict:
        f1c = -(-f1 // _TRACK_BLOCK) * _TRACK_BLOCK
        floor_f1 = (f1 // _TRACK_BLOCK) * _TRACK_BLOCK
        self._walk("commit", f1c, floor_f1)
        snap = self._snapshot_all()
        self._walk("prov", f1c, floor_f1)
        try:
            prog = {"active_from": self.active_from.copy()}
            for name in self.scale_order:
                sc = self.scales[name]
                prog[f"scale_{name}"] = columns_window(
                    sc.starts, sc.cols, sc.col_dtypes, sc.cursors, f0, f1, KP)
            for site, st in self.painter_sites.items():
                starts, vals = new_painter_window(self.V, KP, f1)
                for v in range(self.V):
                    st.cursors[v] = painter_segs_window(
                        st.streams[v].segs, st.cursors[v], f0, f1, KP,
                        starts, vals, v)
                prog[f"prog_{site}"] = {"starts": starts, **vals}
        finally:
            # restore even when a window overflows slot capacity — the caller
            # retries with a larger KP against un-corrupted carried state
            self._restore_all(snap)
        return prog
