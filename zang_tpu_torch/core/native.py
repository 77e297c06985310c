"""Build and load the native (C++) host event compiler via ctypes.

A copy of zang_tpu/core/native.py: the port keeps its own host core and
imports nothing of zang_tpu. The source is zang_tpu_torch/csrc/zang_host.cpp:
its event compiler is a copy of the JAX package's; its envelope compiler
walks every voice of a part in one call, and reads a stage that starts at
t = 0 from a table of that stage's t sequence in place of a step a sample
(the same f32 adds in the same order). It is compiled with g++ at first use
under strict fp rules (-ffp-contract=off: the NoteTracker clock is f32-exact
and FMA contraction would move frame boundaries) into zang_tpu_torch/build/,
keyed by a hash of source and flags (ops/_build.build_shared). A failed
build raises.
"""

import ctypes
import os
import shutil
import threading

import numpy as np

from .. import trace
from ..ops import _build

SRC = os.path.join(_build.SRC_DIR, "zang_host.cpp")
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off",
             "-fno-fast-math"]

_lib = None
_lib_lock = threading.Lock()


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the native host compiler "
                           "of zang_tpu_torch cannot be built")
    return found


def build() -> float:
    """Build (or load) the host compiler; returns the seconds g++ took
    (0.0 when an up-to-date build was on disk)."""
    lib()
    return _build.build_seconds["zang_host"]


def lib():
    """The loaded library, its entries typed. Threads that ask at once load
    it once; it is published only when typed."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _load():
    _lib = ctypes.CDLL(_build.build_shared(SRC, _gxx, GXX_FLAGS, "zang_host"))
    _lib.zt_compile_timelines.restype = ctypes.c_int
    _lib.zt_compile_envelopes.restype = ctypes.c_int
    _lib.zt_compile_envelopes.argtypes = [
        ctypes.c_int,                      # num_voices
        ctypes.POINTER(ctypes.c_int64),    # seg_offsets [V + 1]
        ctypes.POINTER(ctypes.c_int64),    # starts
        ctypes.POINTER(ctypes.c_uint8),    # resets
        ctypes.c_int64,                    # total
        ctypes.POINTER(ctypes.c_uint8),    # note_on
        ctypes.POINTER(ctypes.c_int32),    # attack_kind
        ctypes.POINTER(ctypes.c_float),    # attack_dur
        ctypes.POINTER(ctypes.c_int32),    # decay_kind
        ctypes.POINTER(ctypes.c_float),    # decay_dur
        ctypes.POINTER(ctypes.c_int32),    # release_kind
        ctypes.POINTER(ctypes.c_float),    # release_dur
        ctypes.POINTER(ctypes.c_float),    # sustain
        ctypes.c_float,                    # sample_rate
        ctypes.POINTER(ctypes.c_int64),    # out_offsets [V + 1]
        ctypes.POINTER(ctypes.c_int64),    # seg_start
        ctypes.POINTER(ctypes.c_float),    # a
        ctypes.POINTER(ctypes.c_float),    # b
        ctypes.POINTER(ctypes.c_float),    # t_step
        ctypes.POINTER(ctypes.c_float),    # t0
        ctypes.POINTER(ctypes.c_int32),    # shape
        ctypes.POINTER(ctypes.c_int32),    # out_counts [V]
        ctypes.POINTER(ctypes.c_int64),    # stage_walks [2]
        ctypes.POINTER(ctypes.c_int32),    # failed_voice
    ]
    _lib.zt_compile_timelines.argtypes = [
        ctypes.POINTER(ctypes.c_float),    # ev_t
        ctypes.POINTER(ctypes.c_int32),    # ev_note_id
        ctypes.POINTER(ctypes.c_uint8),    # ev_note_on
        ctypes.POINTER(ctypes.c_int32),    # ev_eq_class
        ctypes.c_int,                      # num_events
        ctypes.c_int,                      # polyphony
        ctypes.c_float,                    # sample_rate
        ctypes.c_int64,                    # total_frames
        ctypes.c_int,                      # block_size
        ctypes.POINTER(ctypes.c_int64),    # seg_starts
        ctypes.POINTER(ctypes.c_uint8),    # seg_resets
        ctypes.POINTER(ctypes.c_int32),    # seg_event
        ctypes.c_int,                      # cap
        ctypes.POINTER(ctypes.c_int32),    # seg_counts
    ]
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def compile_timelines_native(song, polyphony, sample_rate, total_frames,
                             block_size=1024):
    """C++ twin of timeline.compile_timelines. Returns the same
    List[SubvoiceTimeline] (params are the original event dicts)."""
    from .timeline import SubvoiceTimeline

    E = len(song)
    ev_t = np.array([np.float32(ev.t) for ev in song], dtype=np.float32)
    ev_note_id = np.array([ev.note_id for ev in song], dtype=np.int32)
    ev_note_on = np.array(
        [1 if ev.params.get("note_on", False) else 0 for ev in song],
        dtype=np.uint8,
    )
    # params value-equality classes (the Python dedup compares dicts)
    classes = {}
    ev_eq = np.empty(E, dtype=np.int32)
    for i, ev in enumerate(song):
        key = tuple(sorted(ev.params.items()))
        ev_eq[i] = classes.setdefault(key, len(classes))

    cap = max(E + 16, 64)
    P = max(polyphony, 1)
    seg_starts = np.empty((P, cap), dtype=np.int64)
    seg_resets = np.empty((P, cap), dtype=np.uint8)
    seg_event = np.empty((P, cap), dtype=np.int32)
    seg_counts = np.zeros(P, dtype=np.int32)

    rc = lib().zt_compile_timelines(
        _ptr(ev_t, ctypes.c_float), _ptr(ev_note_id, ctypes.c_int32),
        _ptr(ev_note_on, ctypes.c_uint8), _ptr(ev_eq, ctypes.c_int32),
        E, polyphony, ctypes.c_float(np.float32(sample_rate)),
        int(total_frames), int(block_size),
        _ptr(seg_starts, ctypes.c_int64), _ptr(seg_resets, ctypes.c_uint8),
        _ptr(seg_event, ctypes.c_int32), cap,
        _ptr(seg_counts, ctypes.c_int32),
    )
    if rc == 1:
        raise ValueError("song events out of chronological order")
    if rc == 2:
        raise RuntimeError("native timeline compiler: segment capacity exceeded")

    out = []
    for v in range(polyphony):
        k = int(seg_counts[v])
        out.append(
            SubvoiceTimeline(
                starts=seg_starts[v, :k].copy(),
                resets=seg_resets[v, :k].astype(bool),
                params=[song[e].params for e in seg_event[v, :k]],
                total=int(total_frames),
            )
        )
    return out


_CURVE_KIND = {"instantaneous": 0, "linear": 1, "squared": 2, "cubed": 3}

# the per-segment stage columns of zt_compile_envelopes, in its order
STAGE_COLUMNS = (("attack_kind", np.int32), ("attack_dur", np.float32),
                 ("decay_kind", np.int32), ("decay_dur", np.float32),
                 ("release_kind", np.int32), ("release_dur", np.float32),
                 ("sustain", np.float32))


def stage_values(env: dict) -> dict:
    """One segment's envelope parameters ({"attack", "decay", "release":
    PaintCurve, "sustain_volume"}) as the values of STAGE_COLUMNS."""
    out = {"sustain": np.float32(env["sustain_volume"])}
    for stage in ("attack", "decay", "release"):
        curve = env[stage]
        out[stage + "_kind"] = _CURVE_KIND[curve.kind]
        out[stage + "_dur"] = np.float32(curve.duration)
    return out


def compile_envelopes_native(cols, sample_rate, stages: dict, note_on) -> dict:
    """The envelopes of a part's voices in one native call.

    cols: the part's core.timeline.PartColumns; stages: each name of
    STAGE_COLUMNS -> a value for every segment or a column [N]; note_on:
    bool [N]. Returns the painter segments as flat columns {"start", "a",
    "b", "t_step", "t0", "shape"}, voice v's at [offsets[v], offsets[v] +
    counts[v]), with "offsets" and "counts". Counts plan.envelope_calls (a
    call), plan.stage_table and plan.stage_stepped (the stage walks read
    from a table and stepped a sample at a time) in zang_tpu_torch/trace."""
    N, V = len(cols.starts), cols.num_voices
    col = {name: np.ascontiguousarray(np.broadcast_to(np.asarray(stages[name], dt), (N,)))
           for name, dt in STAGE_COLUMNS}
    note_on = np.ascontiguousarray(note_on, np.uint8)
    resets = np.ascontiguousarray(cols.resets, np.uint8)
    starts = np.ascontiguousarray(cols.starts, np.int64)
    seg_offsets = np.ascontiguousarray(cols.offsets, np.int64)
    # a segment paints at most attack, decay and a flat, after one constant
    out_offsets = np.zeros(V + 1, np.int64)
    np.cumsum(4 * cols.counts + 16, out=out_offsets[1:])
    cap = int(out_offsets[-1])
    out = {"start": np.empty(cap, np.int64), "a": np.empty(cap, np.float32),
           "b": np.empty(cap, np.float32), "t_step": np.empty(cap, np.float32),
           "t0": np.empty(cap, np.float32), "shape": np.empty(cap, np.int32)}
    counts = np.zeros(V, np.int32)
    walks = np.zeros(2, np.int64)
    failed = np.zeros(1, np.int32)
    f, i32 = ctypes.c_float, ctypes.c_int32
    rc = lib().zt_compile_envelopes(
        V, _ptr(seg_offsets, ctypes.c_int64), _ptr(starts, ctypes.c_int64),
        _ptr(resets, ctypes.c_uint8), int(cols.total), _ptr(note_on, ctypes.c_uint8),
        _ptr(col["attack_kind"], i32), _ptr(col["attack_dur"], f),
        _ptr(col["decay_kind"], i32), _ptr(col["decay_dur"], f),
        _ptr(col["release_kind"], i32), _ptr(col["release_dur"], f),
        _ptr(col["sustain"], f), ctypes.c_float(np.float32(sample_rate)),
        _ptr(out_offsets, ctypes.c_int64), _ptr(out["start"], ctypes.c_int64),
        _ptr(out["a"], f), _ptr(out["b"], f), _ptr(out["t_step"], f),
        _ptr(out["t0"], f), _ptr(out["shape"], i32), _ptr(counts, i32),
        _ptr(walks, ctypes.c_int64), _ptr(failed, i32),
    )
    trace.count("plan.envelope_calls")
    trace.count("plan.stage_table", int(walks[0]))
    trace.count("plan.stage_stepped", int(walks[1]))
    if rc == 3:
        raise ValueError(
            "note_on while in release without a new note id "
            f"(voice {int(failed[0])}; the reference asserts here - Envelope.zig:45)"
        )
    if rc != 0:
        raise RuntimeError(f"native envelope compiler failed (rc={rc}, voice {int(failed[0])})")
    out["offsets"] = out_offsets[:-1]
    out["counts"] = counts
    return out


def segment_stages(cols, env_params_fn):
    """(stages, note_on) of compile_envelopes_native from a call a segment:
    env_params_fn(voice, k, params) -> {"attack", "decay", "release",
    "sustain_volume", "note_on"} (parameters that vary by segment)."""
    N = len(cols.starts)
    stages = {name: np.empty(N, dt) for name, dt in STAGE_COLUMNS}
    note_on = np.empty(N, bool)
    for j, (v, k, p) in enumerate(cols.segments()):
        env = env_params_fn(v, k, p)
        note_on[j] = bool(env["note_on"])
        for name, value in stage_values(env).items():
            stages[name][j] = value
    return stages, note_on
