"""Build and load the oracle's native (C++) inner loops via ctypes (a copy
of zang_tpu/oracle/native.py).

The source is zang_tpu_torch/csrc/zang_oracle.cpp, a copy of the JAX
package's. It is compiled with g++ at first use under the JAX oracle's
strict fp flags (-ffp-contract=off, no fast-math: FMA contraction would
change the rounding the oracle pins) into zang_tpu_torch/build/, keyed by a
hash of source and flags (ops/_build.build_shared writes a temp file and
renames it, so workers that build at once never read half a library). A
failed build raises.
"""

import ctypes
import os
import threading

import numpy as np

from ..core.native import GXX_FLAGS, _gxx
from ..ops import _build

SRC = os.path.join(_build.SRC_DIR, "zang_oracle.cpp")

_lib = None
_lib_lock = threading.Lock()


def build() -> float:
    """Build (or load) the oracle's library; returns the seconds g++ took
    (0.0 when an up-to-date build was on disk)."""
    lib()
    return _build.build_seconds["zang_oracle"]


def lib() -> ctypes.CDLL:
    """The loaded library, its entries typed. Threads that ask at once load
    it once; it is published only when typed."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    L = ctypes.CDLL(_build.build_shared(SRC, _gxx, GXX_FLAGS, "zang_oracle"))

    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.c_int
    i64 = ctypes.c_int64
    f32 = ctypes.c_float

    L.zo_sine_exact.argtypes = [f32p, i32, f32p, i32, f32, f32p, i32, f32, f32p, f32]
    L.zo_sine_parity.argtypes = [f32p, i32, u32p, i32, f32, f32p, i32, f32, f32p, f32]
    L.zo_pulse_const.argtypes = [f32p, i32, u32p, f32, f32, f32]
    L.zo_pulse_ctl.argtypes = [f32p, i32, u32p, f32, f32p, f32]
    L.zo_trisaw_const.argtypes = [f32p, i32, u32p, f32, f32, f32]
    L.zo_trisaw_ctl_exact.argtypes = [f32p, i32, f32p, f32, f32p, f32]
    L.zo_trisaw_ctl_parity.argtypes = [f32p, i32, u32p, f32, f32p, f32]
    L.zo_paint_toward.argtypes = [
        f32p, i32, i32, f32p, f32p, f32, i32, f32, f32, f32,
        ctypes.POINTER(ctypes.c_int),
    ]
    L.zo_paint_toward.restype = i32
    L.zo_filter.argtypes = [f32p, f32p, i32, f32p, f32p, f32, f32, f32, i32, f32, f32p, i32, f32, f32p]
    L.zo_noise_pink.argtypes = [f32p, f32p, i32, f32p]
    L.zo_decimator_exact.argtypes = [f32p, f32p, i32, f32p, f32p, f32]
    L.zo_distortion.argtypes = [f32p, f32p, i32, i32, f32, f32, f32]
    L.zo_cycle_exact.argtypes = [f32p, i32, f32p, i32, f32, f32p, f32]
    L.zo_sampler_resample_exact.argtypes = [f32p, i32, f32p, f32, u8p, i64, i32, i32, i32, i32]
    L.zo_sampler_resample_parity.argtypes = [f32p, i32, f32p, f32, u8p, i64, i32, i32, i32, i32]
    L.zo_sampler_copy.argtypes = [f32p, i32, f32, u8p, i64, i32, i32, i32, i32]
    L.zo_curve_linear_exact.argtypes = [f32p, i32, f32, f32]
    L.zo_curve_smoothstep_exact.argtypes = [f32p, i32, f32, f32, f32, f32]
    L.zo_curve_linear_parity.argtypes = [f32p, i32, f32, f32]
    L.zo_curve_smoothstep_parity.argtypes = [f32p, i32, f32, f32, f32, f32]
    L.zo_fm_feedback.argtypes = [f32p, f32p, i32, f32, i32, f32p, f32p]
    return L


def fptr(a: np.ndarray):
    assert a.dtype == np.float32 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def u32ptr(a: np.ndarray):
    assert a.dtype == np.uint32 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def u8ptr(a: np.ndarray):
    assert a.dtype == np.uint8 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


NULL_F32 = ctypes.POINTER(ctypes.c_float)()
