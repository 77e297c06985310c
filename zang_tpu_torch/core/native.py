"""Build and load the native (C++) host event compiler via ctypes.

A copy of zang_tpu/core/native.py: the port keeps its own host core and
imports nothing of zang_tpu. The source is zang_tpu_torch/csrc/zang_host.cpp
(a copy of the JAX package's). It is compiled with g++ at first use under
strict fp rules (-ffp-contract=off: the NoteTracker clock is f32-exact and
FMA contraction would move frame boundaries) into zang_tpu_torch/build/,
keyed by a hash of source and flags (ops/_build.build_shared). A failed
build raises.
"""

import ctypes
import os
import shutil
import threading

import numpy as np

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
    _lib.zt_compile_envelope.restype = ctypes.c_int
    _lib.zt_compile_envelope.argtypes = [
        ctypes.POINTER(ctypes.c_int64),    # starts
        ctypes.POINTER(ctypes.c_uint8),    # resets
        ctypes.c_int,                      # num_segs
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
        ctypes.POINTER(ctypes.c_int64),    # seg_start
        ctypes.POINTER(ctypes.c_float),    # a
        ctypes.POINTER(ctypes.c_float),    # b
        ctypes.POINTER(ctypes.c_float),    # t_step
        ctypes.POINTER(ctypes.c_float),    # t0
        ctypes.POINTER(ctypes.c_int32),    # shape
        ctypes.c_int,                      # cap
        ctypes.POINTER(ctypes.c_int32),    # out_count
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


def compile_envelope_native(tl, sample_rate, env_params_fn):
    """C++ twin of ops.control.compile_envelope. Returns segments as a dict
    of arrays {"start","a","b","t_step","t0","shape"} (accepted by
    ops.control.painter_program)."""
    K = len(tl.starts)
    starts = np.ascontiguousarray(tl.starts, dtype=np.int64)
    resets = np.ascontiguousarray(tl.resets, dtype=np.uint8)
    note_on = np.empty(K, np.uint8)
    ak = np.empty(K, np.int32); ad = np.empty(K, np.float32)
    dk = np.empty(K, np.int32); dd = np.empty(K, np.float32)
    rk = np.empty(K, np.int32); rd = np.empty(K, np.float32)
    sus = np.empty(K, np.float32)
    for k in range(K):
        p = env_params_fn(k, tl.params[k])
        note_on[k] = 1 if p["note_on"] else 0
        for kindarr, durarr, c in ((ak, ad, p["attack"]), (dk, dd, p["decay"]),
                                   (rk, rd, p["release"])):
            kindarr[k] = _CURVE_KIND[c.kind]
            durarr[k] = np.float32(c.duration)
        sus[k] = np.float32(p["sustain_volume"])

    cap = 4 * K + 16
    out_start = np.empty(cap, np.int64)
    out_a = np.empty(cap, np.float32)
    out_b = np.empty(cap, np.float32)
    out_ts = np.empty(cap, np.float32)
    out_t0 = np.empty(cap, np.float32)
    out_sh = np.empty(cap, np.int32)
    count = np.zeros(1, np.int32)
    rc = lib().zt_compile_envelope(
        _ptr(starts, ctypes.c_int64), _ptr(resets, ctypes.c_uint8), K,
        int(tl.total), _ptr(note_on, ctypes.c_uint8),
        _ptr(ak, ctypes.c_int32), _ptr(ad, ctypes.c_float),
        _ptr(dk, ctypes.c_int32), _ptr(dd, ctypes.c_float),
        _ptr(rk, ctypes.c_int32), _ptr(rd, ctypes.c_float),
        _ptr(sus, ctypes.c_float), ctypes.c_float(np.float32(sample_rate)),
        _ptr(out_start, ctypes.c_int64), _ptr(out_a, ctypes.c_float),
        _ptr(out_b, ctypes.c_float), _ptr(out_ts, ctypes.c_float),
        _ptr(out_t0, ctypes.c_float), _ptr(out_sh, ctypes.c_int32),
        cap, _ptr(count, ctypes.c_int32),
    )
    if rc == 3:
        raise ValueError(
            "note_on while in release without a new note id "
            "(the reference asserts here - Envelope.zig:45)"
        )
    if rc != 0:
        raise RuntimeError(f"native envelope compiler failed (rc={rc})")
    n = int(count[0])
    return {
        "start": out_start[:n].copy(), "a": out_a[:n].copy(),
        "b": out_b[:n].copy(), "t_step": out_ts[:n].copy(),
        "t0": out_t0[:n].copy(), "shape": out_sh[:n].copy(),
    }
