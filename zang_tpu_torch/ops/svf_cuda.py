"""Wrappers of the SVF CUDA kernels, the counterparts of
zang_tpu/ops/pallas_svf.py:

  svf_table_cuda  the table-cut kernel (csrc/svf_table.cu, K1), for
                  svf_filter_pallas_table
  svf_dense_cuda  the dense-cut kernel (csrc/svf_dense.cu, K2), for
                  svf_filter_pallas
  svf_onepass_cuda  the one-pass table-cut kernel for large voice counts
                  (csrc/svf_onepass.cu, K3), for svf_onepass_table

Each checks device, dtype, shape and contiguity, allocates the outputs with
torch.empty, launches on torch.cuda.current_stream() and raises if the
launch is refused. svf_table_launches, svf_dense_launches and
svf_onepass_launches count the launches.
"""

import ctypes

import numpy as np
import torch

from . import _build

svf_table_launches = 0
svf_dense_launches = 0
svf_onepass_launches = 0

_C = ctypes.c_void_p
_I64 = ctypes.c_longlong


# source stem -> its C function and argument types
_ARGTYPES = {
    "svf_table": [_C] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [_C],
    "svf_onepass": [_C] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [_C],
    "svf_dense": [_C] * 8 + [ctypes.c_int] * 2 + [_I64] * 4 + [ctypes.c_float] * 5 + [_C],
}


def _fn(stem):
    """The C entry zt_<stem> of csrc/<stem>.cu, built at first use."""
    fn = getattr(_build.library(stem), f"zt_{stem}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[stem]
        fn.restype = ctypes.c_int
    return fn


def _r(res) -> np.float32:
    """r = 1 - clip(res, 0, 1) in f32, as the plain version computes it."""
    return np.float32(1.0) - np.clip(np.float32(res), np.float32(0.0), np.float32(1.0))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch_table_cut(stem, l0, b0, x, filter_type, tb, cutv, res, t0, active_from, out):
    """Check the arguments that the two table-cut kernels share (see
    svf_table_cuda), allocate what is not given and launch zt_<stem>.
    Returns (l_end, b_end, out)."""
    from .filters import FILTER_MULS

    if x.device.type != "cuda":
        raise ValueError(f"{stem}_cuda needs CUDA tensors, got x on {x.device}")
    if x.dim() != 2 or tb.dim() != 3:
        raise ValueError(f"x must be [V, n] and tb [V, nt, S]; got {tuple(x.shape)}, "
                         f"{tuple(tb.shape)}")
    V, n = x.shape
    _, nt, S = tb.shape
    if nt < 1 or S < 1 or n % nt:
        raise ValueError(f"chunk of {n} frames does not split into {nt} tiles")
    dev = x.device
    cv = torch.clamp(cutv, 0.0, 1.0).contiguous()
    if active_from is None:
        active_from = torch.full((V,), -(2 ** 31), dtype=torch.int32, device=dev)
    if out is None:
        out = torch.empty((V, n), dtype=torch.float32, device=dev)
    for name, t, dtype, shape in (
        ("x", x, torch.float32, (V, n)), ("tb", tb, torch.int32, (V, nt, S)),
        ("cutv", cv, torch.float32, (V, nt, S)),
        ("active_from", active_from, torch.int32, (V,)),
        ("l0", l0, torch.float32, (V,)), ("b0", b0, torch.float32, (V,)),
        ("out", out, torch.float32, (V, n)),
    ):
        _check(name, t, dtype, shape, dev)
    if filter_type not in FILTER_MULS:
        raise ValueError(f"filter type {filter_type!r} has no table kernel")
    l_mul, b_mul, h_mul = FILTER_MULS[filter_type]
    r = _r(res)

    l_end = torch.empty((V,), dtype=torch.float32, device=dev)
    b_end = torch.empty((V,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(stem)(
            x.data_ptr(), tb.data_ptr(), cv.data_ptr(), active_from.data_ptr(),
            l0.data_ptr(), b0.data_ptr(), out.data_ptr(), l_end.data_ptr(),
            b_end.data_ptr(), V, n, nt, S, int(t0), float(r), l_mul, b_mul,
            h_mul, stream)
    if err != 0:
        raise RuntimeError(f"{stem} kernel launch failed: cudaError_t {err}")
    return l_end, b_end, out


def svf_table_cuda(l0, b0, x, filter_type, tb, cutv, res, t0, active_from=None):
    """Drop-in for ops.filters.svf_filter_table on CUDA tensors.

    x: [V, n] f32; tb: [V, nt, S] i32; cutv: [V, nt, S] f32 (raw, clipped
    here to [0, 1]); active_from: [V] i32 or None (always active); l0/b0:
    [V] f32. n % nt == 0. Returns (l_end [V], b_end [V], out [V, n])."""
    global svf_table_launches
    ret = _launch_table_cut("svf_table", l0, b0, x, filter_type, tb, cutv, res, t0,
                            active_from, None)
    svf_table_launches += 1
    return ret


# what svf_onepass.cu is built for: 16-byte copies of x, a tile's slots in registers
ONEPASS_N_MULTIPLE = 4
ONEPASS_MAX_SLOTS = 4


def svf_onepass_cuda(l0, b0, x, filter_type, tb, cutv, res, t0, active_from=None,
                     out=None):
    """The one-pass kernel: svf_table_cuda's arguments and function, as the
    exact sequential recurrence (a thread a voice, no block seams). out:
    None (allocate) or an f32 [V, n] tensor to write to, which is x itself
    (in place: at 16384 voices a second [V, n] buffer is 4 GiB) or shares
    no byte with x. n must be a multiple of 4 (render chunks are multiples
    of 512) and a time tile may have at most 4 slots; svf_table_cuda takes
    the other shapes."""
    global svf_onepass_launches
    if x.dim() == 2 and x.shape[1] % ONEPASS_N_MULTIPLE:
        raise ValueError(f"svf_onepass_cuda needs a chunk that is a multiple of "
                         f"{ONEPASS_N_MULTIPLE} frames, got {x.shape[1]}")
    if tb.dim() == 3 and tb.shape[2] > ONEPASS_MAX_SLOTS:
        raise ValueError(f"svf_onepass_cuda takes at most {ONEPASS_MAX_SLOTS} slots a "
                         f"time tile, got {tb.shape[2]}")
    if out is not None and out.data_ptr() != x.data_ptr():
        size = x.numel() * x.element_size()
        if abs(out.data_ptr() - x.data_ptr()) < size:
            raise ValueError("out overlaps x without being x: the kernel writes "
                             "finished tiles over rows it has yet to read")
    ret = _launch_table_cut("svf_onepass", l0, b0, x, filter_type, tb, cutv, res, t0,
                            active_from, out)
    svf_onepass_launches += 1
    return ret


def svf_dense_cuda(l0, b0, x, filter_type, cutoff, res, active=None):
    """Drop-in for ops.filters.svf_filter on a CUDA x [V, n] with a scalar res.

    cutoff: a number, or an f32 tensor broadcastable to [V, n] (a scalar,
    [V, 1] or [V, n] tensor is read through its broadcast strides, never
    materialised); it is clipped to [0, 1] in the kernel. active: a bool
    tensor broadcastable to [V, n], or None (always active). l0/b0: [V] f32.
    Returns (l_end [V], b_end [V], out [V, n])."""
    global svf_dense_launches
    from .filters import FILTER_MULS

    if x.device.type != "cuda":
        raise ValueError(f"svf_dense_cuda needs CUDA tensors, got x on {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [V, n], got {tuple(x.shape)}")
    V, n = x.shape
    dev = x.device
    for name, t, dtype, shape in (("x", x, torch.float32, (V, n)),
                                  ("l0", l0, torch.float32, (V,)),
                                  ("b0", b0, torch.float32, (V,))):
        _check(name, t, dtype, shape, dev)
    if filter_type not in FILTER_MULS:
        raise ValueError(f"filter type {filter_type!r} has no dense kernel")
    l_mul, b_mul, h_mul = FILTER_MULS[filter_type]
    r = _r(float(res))

    cut, c_sv, c_st, c0 = None, 0, 0, 0.0
    if isinstance(cutoff, torch.Tensor):
        if cutoff.device != dev or cutoff.dtype != torch.float32:
            raise ValueError(f"cutoff must be f32 on {dev}, got {cutoff.dtype} on "
                             f"{cutoff.device}")
        cut = cutoff.broadcast_to((V, n))
        c_sv, c_st = cut.stride()
    else:
        c0 = float(np.clip(np.float32(cutoff), np.float32(0.0), np.float32(1.0)))
    act, a_sv, a_st = None, 0, 0
    if active is not None:
        if active.device != dev or active.dtype != torch.bool:
            raise ValueError(f"active must be bool on {dev}, got {active.dtype} on "
                             f"{active.device}")
        act = active.broadcast_to((V, n))
        a_sv, a_st = act.stride()

    out = torch.empty((V, n), dtype=torch.float32, device=dev)
    l_end = torch.empty((V,), dtype=torch.float32, device=dev)
    b_end = torch.empty((V,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("svf_dense")(
            x.data_ptr(), None if cut is None else cut.data_ptr(),
            None if act is None else act.data_ptr(), l0.data_ptr(), b0.data_ptr(),
            out.data_ptr(), l_end.data_ptr(), b_end.data_ptr(), V, n, c_sv, c_st,
            a_sv, a_st, c0, float(r), l_mul, b_mul, h_mul, stream)
    if err != 0:
        raise RuntimeError(f"svf_dense kernel launch failed: cudaError_t {err}")
    svf_dense_launches += 1
    return l_end, b_end, out
