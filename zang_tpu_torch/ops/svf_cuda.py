"""Wrappers of the SVF CUDA kernels, the counterparts of
zang_tpu/ops/pallas_svf.py:

  svf_table_cuda  the table-cut kernel (csrc/svf_table.cu, K1), for
                  svf_filter_pallas_table; svf_table_geometry is its launch
                  geometry and svf_table_emulated its seams composed in torch
  svf_dense_cuda  the dense-cut kernel (csrc/svf_dense.cu, K2), for
                  svf_filter_pallas; svf_dense_geometry and
                  svf_dense_emulated are its own
  svf_onepass_cuda  the one-pass table-cut kernel for large voice counts
                  (csrc/svf_onepass.cu, K3), for svf_onepass_table

K1 and K2 share one windowed body (csrc/svf_window.cuh) and one emulation
of its seams (_windows_emulated).

Each checks device, dtype, shape and contiguity, allocates the outputs with
torch.empty, launches on torch.cuda.current_stream() and raises if the
launch is refused. Each launch adds one to the counter "launch.svf_table",
"launch.svf_dense" or "launch.svf_onepass" (trace.counters()).
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..trace import count
from . import _build

_C = ctypes.c_void_p
_I64 = ctypes.c_longlong


# source stem -> its C function and argument types
_ARGTYPES = {
    "svf_table": [_C] * 9 + [ctypes.c_int] * 5 + [_C] + [ctypes.c_float] * 4
    + [ctypes.c_int] * 4 + [_C],
    "svf_onepass": [_C] * 9 + [ctypes.c_int] * 5 + [_C] + [ctypes.c_float] * 4 + [_C],
    "svf_dense": [_C] * 8 + [ctypes.c_int] * 2 + [_I64] * 4 + [ctypes.c_float] * 5
    + [ctypes.c_int] * 5 + [_C],
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


def _launch_table_cut(stem, l0, b0, x, filter_type, tb, cutv, res, t0, active_from, out,
                      extra=lambda V, n, nt, S: ()):
    """Check the arguments that the two table-cut kernels share (see
    svf_table_cuda), allocate what is not given and launch zt_<stem>;
    extra(V, n, nt, S) gives the C arguments that follow the shared ones.
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
    extra_args = extra(V, n, nt, S)
    dev = x.device
    t0p = None
    if isinstance(t0, torch.Tensor):  # read on the card (a captured graph's chunk)
        _check("t0", t0, torch.int32, (1,), dev)
        t0p, t0 = t0, 0
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
    if FILTER_MULS.get(filter_type) is None:
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
            b_end.data_ptr(), V, n, nt, S, int(t0), None if t0p is None else t0p.data_ptr(),
            float(r), l_mul, b_mul, h_mul, *extra_args, stream)
    if err != 0:
        raise RuntimeError(f"{stem} kernel launch failed: cudaError_t {err}")
    return l_end, b_end, out


# The windowed body's geometry (csrc/svf_window.cuh), K1's and K2's: a thread
# steps a run of SVF_RUN frames; a block a window of W frames; the blocks of a
# voice form a cluster, which walks the voice's windows in rounds when there
# are more than it has blocks
SVF_RUN = 16
SVF_WINDOW = 8192  # W up to 65,536-frame chunks; n itself below it
SVF_MAX_CLUSTER = 8  # the portable cluster size: W = n / 8 up to 131,072 frames
SVF_MAX_THREADS = 1024  # W at most 16,384 frames: rounds beyond 131,072
SVF_MAX_SHARED = 227 * 1024  # bytes of shared memory a block may have
SVF_PITCH = SVF_RUN + 4  # floats from one run to the next in shared memory


class SvfTableGeometry(NamedTuple):
    window: int  # W, frames a block takes at a time
    cluster: int  # blocks a voice
    rounds: int  # windows a block: n = W * cluster * rounds
    run: int  # frames a thread
    threads: int  # a block's, the runs of a window rounded up to whole warps
    tiles: int  # time tiles of the tables staged with a window, at most
    shared: int  # bytes of dynamic shared memory a block: x and the tables


@functools.lru_cache(maxsize=256)
def svf_table_geometry(V: int, n: int, nt: int, S: int) -> SvfTableGeometry:
    """K1's launch geometry for x [V, n] and tables [V, nt, S]; the C entry
    of csrc/svf_table.cu takes it as it is and only checks it. The windows
    of a voice: n / 8192 of them up to 8, and at least n / 16,384, the
    fewest that cut n into whole runs; the cluster is the largest divisor
    of their count up to 8. Raises ValueError on a shape the kernel does
    not take: n % nt != 0, n not a multiple of 16, or more than
    SVF_MAX_SHARED bytes of window and tables."""
    if V < 1 or n < 1 or nt < 1 or S < 1:
        raise ValueError(f"K1 needs V, n, nt, S >= 1, got {V}, {n}, {nt}, {S}")
    if n % nt:
        raise ValueError(f"chunk of {n} frames does not split into {nt} tiles")
    if n % SVF_RUN:
        raise ValueError(f"K1 cuts a chunk into runs of {SVF_RUN} frames: n = {n} is not "
                         f"a multiple of {SVF_RUN}")
    windows = max(min(SVF_MAX_CLUSTER, -(-n // SVF_WINDOW)),
                  -(-n // (SVF_MAX_THREADS * SVF_RUN)))
    while n % (windows * SVF_RUN):
        windows += 1
    cluster = max(c for c in range(1, SVF_MAX_CLUSTER + 1) if windows % c == 0)
    W = n // windows
    runs = W // SVF_RUN
    threads = -(-runs // 32) * 32
    tiles = min(nt, (W - 1) // (n // nt) + 2)  # the most any window touches, or more
    shared = 4 * runs * SVF_PITCH + 8 * tiles * S
    if shared > SVF_MAX_SHARED:
        raise ValueError(f"K1 stages a window of {W} frames and {tiles} x {S} table "
                         f"slots: {shared} bytes of shared memory, more than "
                         f"{SVF_MAX_SHARED}")
    return SvfTableGeometry(W, cluster, windows // cluster, SVF_RUN, threads, tiles, shared)


def _svf_table_launch(V, n, nt, S):
    """The geometry arguments of zt_svf_table."""
    g = svf_table_geometry(V, n, nt, S)
    return g.cluster, g.rounds, g.threads, g.shared


def svf_table_cuda(l0, b0, x, filter_type, tb, cutv, res, t0, active_from=None):
    """Drop-in for ops.filters.svf_filter_table on CUDA tensors.

    x: [V, n] f32 on 16 bytes; tb: [V, nt, S] i32; cutv: [V, nt, S] f32 (raw,
    clipped here to [0, 1]); active_from: [V] i32 or None (always active);
    l0/b0: [V] f32; t0: an int (passed by value) or an int32 [1] tensor on
    x's device (passed by pointer and read on the card, as a captured CUDA
    graph needs: graph/render.py). The shape must suit svf_table_geometry, which raises
    otherwise. Returns (l_end [V], b_end [V], out [V, n])."""
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("svf_table_cuda copies x 16 bytes at a time: x must start "
                         "on 16 bytes")
    ret = _launch_table_cut(
        "svf_table", l0, b0, x, filter_type, tb, cutv, res, t0, active_from, None,
        extra=_svf_table_launch)
    count("launch.svf_table")
    return ret


def _windows_emulated(l0, b0, x, cut, act, filter_type, res, window, windows, threads):
    """The windowed body's seams composed in torch, on any device: x, cut
    (clipped) and act (bool) [V, n]; `windows` windows of `window` frames
    (their frames from n on inactive), each of `threads` runs of SVF_RUN
    frames (the runs past the window inactive). Runs step their affine maps
    (phase A); the maps are scanned across the 32 runs of a warp, then
    across the warps of a window, then the windows' maps are applied in
    order to (l0, b0), as the cluster's rounds apply them; each run replays
    the recurrence from its start state (phase B). Every f32 operation is
    the kernel's, in its order. Returns (l_end, b_end, out)."""
    from .filters import FILTER_MULS, _svf_step
    from .scan import _affine2_apply, _affine2_combine, associative_scan

    def scan32(m):  # warp_scan: the Kogge-Stone order over 32 lanes
        return associative_scan(_affine2_combine, m)

    V, n = x.shape
    R, dev, nwin = SVF_RUN, x.device, windows
    l_mul, b_mul, h_mul = FILTER_MULS[filter_type]
    r = torch.tensor(_r(res), device=dev)
    # [V, windows, runs of a window, R], the chunk padded to whole windows
    # and the runs to whole warps
    shape = (V, nwin, window // R, R)
    pad = threads - window // R

    def runs(a, fill):
        a = torch.nn.functional.pad(a, (0, nwin * window - n), value=fill).reshape(shape)
        return torch.cat([a, torch.full((*shape[:2], pad, R), fill, dtype=a.dtype,
                                        device=dev)], dim=2) if pad else a

    xr, cr, ar = runs(x, 0.0), runs(cut, 0.0), runs(act, False)

    # phase A: the basis columns under the homogeneous step, as the kernel
    # writes them out
    z, o = torch.zeros(xr.shape[:3], device=dev), torch.ones(xr.shape[:3], device=dev)
    l00, b00, l10, b10, l01, b01 = z, z, o, z, z, o
    for u in range(R):
        k, on = cr[..., u], ar[..., u]
        nl00, nb00, _ = _svf_step(l00, b00, xr[..., u], k, r)
        dl = l10 + k * b10
        db = b10 - k * (b10 * r + dl)
        nl10 = dl + k * db
        nb10 = db - k * (db * r + nl10)
        dl = l01 + k * b01
        db = b01 - k * (b01 * r + dl)
        nl01 = dl + k * db
        nb01 = db - k * (db * r + nl01)
        l00, b00, l10, b10, l01, b01 = (
            torch.where(on, new, old) for new, old in
            ((nl00, l00), (nb00, b00), (nl10, l10), (nb10, b10), (nl01, l01), (nb01, b01)))

    # the scan: runs within a warp, warps within a window, windows in order
    nw = threads // 32
    m = scan32(tuple(e.reshape(V, nwin, nw, 32)
                      for e in (l10, l01, b10, b01, l00, b00)))
    ident = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    wt = tuple(torch.cat([e[..., 31], torch.full((V, nwin, 32 - nw), iv, device=dev)],
                         dim=-1) for e, iv in zip(m, ident))
    wt = scan32(wt)  # [V, windows, 32]: the warps' inclusive prefixes
    starts_l, starts_b, l, b = [], [], l0, b0
    for q in range(nwin):
        starts_l.append(l)
        starts_b.append(b)
        l, b = _affine2_apply(tuple(e[:, q, nw - 1] for e in wt), l, b)
    sl = torch.stack(starts_l, dim=1)[:, :, None].expand(V, nwin, nw).clone()
    sb = torch.stack(starts_b, dim=1)[:, :, None].expand(V, nwin, nw).clone()
    wl, wb = _affine2_apply(tuple(e[..., :nw - 1] for e in wt), sl[..., 1:], sb[..., 1:])
    sl[..., 1:], sb[..., 1:] = wl, wb  # each warp's start
    sl, sb = sl[..., None].expand(m[0].shape), sb[..., None].expand(m[0].shape)
    ll, lb = _affine2_apply(tuple(torch.roll(e, 1, dims=-1) for e in m), sl, sb)
    lane = torch.arange(32, device=dev)
    l = torch.where(lane > 0, ll, sl).reshape(xr.shape[:3])
    b = torch.where(lane > 0, lb, sb).reshape(xr.shape[:3])

    # phase B
    out = torch.empty_like(xr)
    for u in range(R):
        on = ar[..., u]
        nl, nb, h = _svf_step(l, b, xr[..., u], cr[..., u], r)
        out[..., u] = torch.where(on, nl * l_mul + nb * b_mul + h * h_mul, 0.0)
        l, b = torch.where(on, nl, l), torch.where(on, nb, b)
    # the end state: the run that steps frame n - 1 (the frames after it inactive)
    last_w, last_r = (n - 1) // window, (n - 1) % window // R
    out = out[:, :, :window // R].reshape(V, nwin * window)[:, :n]
    return l[:, last_w, last_r], b[:, last_w, last_r], out


def svf_table_emulated(l0, b0, x, filter_type, tb, cutv, res, t0, active_from=None):
    """K1's seams composed in torch, on any device: svf_table_cuda's
    arguments and function, computed as csrc/svf_table.cu computes it
    (_windows_emulated at svf_table_geometry's windows). The cutoff of each
    sample is eval_tiled_chunk's, the rule the kernel's slot pointer
    follows."""
    from .filters import chunk_frames
    from .segprog import eval_tiled_chunk

    V, n = x.shape
    _, nt, S = tb.shape
    g = svf_table_geometry(V, n, nt, S)
    t_idx = chunk_frames(t0, n, x.device)
    cut = eval_tiled_chunk({"tb": tb, "cut": torch.clamp(cutv, 0.0, 1.0)}, t_idx)["cut"]
    act = torch.ones((V, n), dtype=torch.bool, device=x.device) if active_from is None \
        else t_idx[None, :] >= active_from.to(torch.int32)[:, None]
    return _windows_emulated(l0, b0, x, cut, act, filter_type, res, g.window,
                             g.cluster * g.rounds, g.threads)


# what svf_onepass.cu is built for: 16-byte copies of x (a tile's slots are
# held in registers: filters.ONEPASS_MAX_SLOTS)
ONEPASS_N_MULTIPLE = 4


def svf_onepass_cuda(l0, b0, x, filter_type, tb, cutv, res, t0, active_from=None,
                     out=None):
    """The one-pass kernel: svf_table_cuda's arguments and function, as the
    exact sequential recurrence (a thread a voice, no block seams). out:
    None (allocate) or an f32 [V, n] tensor to write to, which is x itself
    (in place: at 16384 voices a second [V, n] buffer is 4 GiB) or shares
    no byte with x. n must be a multiple of 4 (render chunks are multiples
    of 512) and a time tile may have at most 4 slots; svf_table_cuda takes
    the other shapes."""
    from .filters import ONEPASS_MAX_SLOTS

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
    count("launch.svf_onepass")
    return ret


class SvfDenseGeometry(NamedTuple):
    window: int  # W, frames a block takes at a time (whole runs)
    cluster: int  # blocks a voice
    rounds: int  # windows a block: W * cluster * rounds >= n, the rest inactive
    run: int  # frames a thread
    threads: int  # a block's, the runs of a window rounded up to whole warps


@functools.lru_cache(maxsize=256)
def svf_dense_geometry(V: int, n: int) -> SvfDenseGeometry:
    """K2's launch geometry for x [V, n], any V, n >= 1; the C entry of
    csrc/svf_dense.cu takes it as it is and only checks it. As K1's
    windows, without K1's need to cut n whole: n / 8192 windows up to 8 and
    at least n / 16,384, the cluster their count up to 8 and the rounds the
    rest; the window is the fewest whole runs that cover n in that many
    windows, so the last window (and, at most, a round's last few) may end
    past n."""
    if V < 1 or n < 1:
        raise ValueError(f"K2 needs V, n >= 1, got {V}, {n}")
    windows = max(min(SVF_MAX_CLUSTER, -(-n // SVF_WINDOW)),
                  -(-n // (SVF_MAX_THREADS * SVF_RUN)))
    cluster = min(windows, SVF_MAX_CLUSTER)
    rounds = -(-windows // cluster)
    runs = -(-(-(-n // SVF_RUN)) // (cluster * rounds))
    return SvfDenseGeometry(runs * SVF_RUN, cluster, rounds, SVF_RUN, -(-runs // 32) * 32)


def svf_dense_shared(g: SvfDenseGeometry, dense_cut: bool, mask_row: bool) -> int:
    """Bytes of dynamic shared memory a K2 block stages: the window of x, and
    of a cutoff row and a mask row where given."""
    runs = g.window // g.run
    return 4 * runs * SVF_PITCH * (2 if dense_cut else 1) + (16 * runs if mask_row else 0)


def _along_time(t, V, n):
    """t broadcast to [V, n] as K2 reads it: (the view, its stride from voice
    to voice, its stride along time, 0 or 1). A tensor that runs along time
    with another stride is made contiguous first."""
    t = t.broadcast_to((V, n))
    if n > 1 and t.stride(1) not in (0, 1):
        t = t.contiguous()
    return t, t.stride(0), t.stride(1) if n > 1 else 0


def _dense_forms(V, n, cutoff, active, dev):
    """K2's cutoff and mask forms: (cut [V, n] view or None, its strides, the
    clipped scalar c0, act [V, n] view or None, its strides)."""
    cut, c_sv, c_st, c0 = None, 0, 0, 0.0
    if isinstance(cutoff, torch.Tensor):
        if cutoff.device != dev or cutoff.dtype != torch.float32:
            raise ValueError(f"cutoff must be f32 on {dev}, got {cutoff.dtype} on "
                             f"{cutoff.device}")
        cut, c_sv, c_st = _along_time(cutoff, V, n)
    else:
        c0 = float(np.clip(np.float32(cutoff), np.float32(0.0), np.float32(1.0)))
    act, a_sv, a_st = None, 0, 0
    if active is not None:
        if active.device != dev or active.dtype != torch.bool:
            raise ValueError(f"active must be bool on {dev}, got {active.dtype} on "
                             f"{active.device}")
        act, a_sv, a_st = _along_time(active, V, n)
    return cut, c_sv, c_st, c0, act, a_sv, a_st


def svf_dense_cuda(l0, b0, x, filter_type, cutoff, res, active=None):
    """Drop-in for ops.filters.svf_filter on a CUDA x [V, n] with a scalar res.

    cutoff: a number, or an f32 tensor broadcastable to [V, n] (a scalar,
    [V, 1] or [V, n] tensor is read through its broadcast strides, never
    materialised); it is clipped to [0, 1] in the kernel. active: a bool
    tensor broadcastable to [V, n], or None (always active). l0/b0: [V] f32.
    Any V, n >= 1 (svf_dense_geometry). Returns (l_end [V], b_end [V],
    out [V, n])."""
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
    if FILTER_MULS.get(filter_type) is None:
        raise ValueError(f"filter type {filter_type!r} has no dense kernel")
    l_mul, b_mul, h_mul = FILTER_MULS[filter_type]
    r = _r(float(res))
    g = svf_dense_geometry(V, n)
    cut, c_sv, c_st, c0, act, a_sv, a_st = _dense_forms(V, n, cutoff, active, dev)
    shared = svf_dense_shared(g, cut is not None and c_st == 1, act is not None and a_st == 1)

    out = torch.empty((V, n), dtype=torch.float32, device=dev)
    l_end = torch.empty((V,), dtype=torch.float32, device=dev)
    b_end = torch.empty((V,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("svf_dense")(
            x.data_ptr(), None if cut is None else cut.data_ptr(),
            None if act is None else act.data_ptr(), l0.data_ptr(), b0.data_ptr(),
            out.data_ptr(), l_end.data_ptr(), b_end.data_ptr(), V, n, c_sv, c_st,
            a_sv, a_st, c0, float(r), l_mul, b_mul, h_mul, g.window, g.cluster, g.rounds,
            g.threads, shared, stream)
    if err != 0:
        raise RuntimeError(f"svf_dense kernel launch failed: cudaError_t {err}")
    count("launch.svf_dense")
    return l_end, b_end, out


def svf_dense_emulated(l0, b0, x, filter_type, cutoff, res, active=None):
    """K2's seams composed in torch, on any device: svf_dense_cuda's
    arguments and function, computed as csrc/svf_dense.cu computes it
    (_windows_emulated at svf_dense_geometry's windows)."""
    from .scan import as_f32

    V, n = x.shape
    g = svf_dense_geometry(V, n)
    cut = torch.clamp(as_f32(cutoff, x), 0.0, 1.0).broadcast_to((V, n))
    act = torch.ones((V, n), dtype=torch.bool, device=x.device) if active is None \
        else active.broadcast_to((V, n))
    return _windows_emulated(l0, b0, x, cut, act, filter_type, res, g.window,
                             g.cluster * g.rounds, g.threads)
