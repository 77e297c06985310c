"""Build and load the oracle's native (C++) inner loops via ctypes, frozen
for the benchmark from zang_tpu_torch/oracle/native.py.

The source is zang_oracle.cpp beside this file, a copy of the port's
csrc/zang_oracle.cpp. It is compiled with g++ at first use under the
oracle's strict fp flags (-ffp-contract=off, no fast-math: FMA contraction
would change the rounding the oracle pins) into benchmark/.build/ (a fixed
directory inside the checkout, listed in benchmark/.gitignore), keyed by a
hash of source and flags, so a cell's later runs load it from there. The
library is written to a temp file and renamed. A failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "zang_oracle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), ".build")
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off",
             "-fno-fast-math"]

_lib = None
_lib_lock = threading.Lock()


def build_shared() -> str:
    """The library's path, compiled with g++ unless it is on disk."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libzang_oracle_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the reference cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SRC], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


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
    L = ctypes.CDLL(build_shared())

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
