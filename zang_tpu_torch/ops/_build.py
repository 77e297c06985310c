"""Build the CUDA sources in csrc/ with nvcc into a shared library with a
plain C interface, and load it with ctypes (core/native.py builds the C++
host compiler through build_shared too).

The library is built at first use into zang_tpu_torch/build/ (listed in
.gitignore) and rebuilt when the source, the headers in csrc/ or the flags
change: the file name carries their hash. A failed build raises with nvcc's
stderr; there is no fallback.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# --fmad=false: the SVF step is held to the reference in exact f32 order
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_loaded = {}  # source name -> ctypes.CDLL, one load per process
build_seconds = {}  # library stem -> seconds spent compiling (0.0 if cached)
_locks = {}  # library stem -> its lock: threads build and load a stem once
_locks_lock = threading.Lock()


def _stem_lock(stem: str) -> threading.Lock:
    with _locks_lock:
        return _locks.setdefault(stem, threading.Lock())


def nvcc_path() -> str:
    """nvcc under $CUDA_HOME, else /usr/local/cuda, else on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin or PATH): "
            "the CUDA kernels of zang_tpu_torch cannot be built")
    return found


def build_shared(src: str, compiler, flags: list, stem: str, deps=()) -> str:
    """Compile `src` with `compiler() + flags` into BUILD_DIR/lib<stem>_<hash>.so
    unless that file exists; the hash covers the source, the files in deps
    (the headers it includes) and the flags. compiler is called only when a
    build is needed and returns the compiler's path. Returns the .so path. A
    failed build raises with the compiler's stderr.

    Threads of one process build a stem one at a time (a lock per stem), and
    processes each write a temp file of their own, named by process and
    thread; os.replace puts it in place last, so no reader sees half a file."""
    h = hashlib.sha256()
    for path in (src, *sorted(deps)):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    with _stem_lock(stem):
        if os.path.exists(so):
            build_seconds[stem] = 0.0
            return so
        cc = compiler()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        t = time.perf_counter()
        proc = subprocess.run([cc, *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        build_seconds[stem] = time.perf_counter() - t
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cc} failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stderr}")
        if proc.stderr.strip():  # warnings
            sys.stderr.write(proc.stderr)
        os.replace(tmp, so)
    return so


def library(name: str) -> ctypes.CDLL:
    """Load csrc/<name>.cu as a shared library, building it if needed."""
    if name in _loaded:
        return _loaded[name]
    with _stem_lock("load:" + name):
        if name not in _loaded:
            so = build_shared(os.path.join(SRC_DIR, name + ".cu"), nvcc_path, NVCC_FLAGS,
                              name, deps=glob.glob(os.path.join(SRC_DIR, "*.cuh")))
            _loaded[name] = ctypes.CDLL(so)
    return _loaded[name]


def build(name: str) -> float:
    """Build (or load) csrc/<name>.cu; returns the seconds nvcc took (0.0
    when an up-to-date build was on disk)."""
    library(name)
    return build_seconds[name]
