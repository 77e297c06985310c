"""One chunk's tiled slice of a segment program, cut on the device from the
program's [V, K] tables (ops/segprog.py chunkify_tiled, one chunk of it):

  tile_windows(table, plan, c0)  {"tb": [V, nt, S] int32, name: [V, nt, S]}
                                 for the chunk whose first frame is c0
                                 (an int, or int32 [1] on the device)

For each voice and tile (first frame ts = c0 + i * tile): first = the last
segment starting at or before ts (0 when none does), last = the segments
starting before ts + tile, at most cap (the voice's segments starting
before total, at least 1). Slot j holds segment first + j: its start in
"tb" while first + j < last, else total + 1 (never reached), slot 0 -2^31
(it covers the tile's start); its values clamped to segment last - 1 and
to [0, K - 1]. chunkify_tiled's arrays for that chunk, bit for bit.

tile_windows_ref is the plain version (torch.searchsorted and gathers),
which runs on any device and which the router takes for CPU tensors; for
CUDA tensors it launches the hand-written kernel csrc/tile_windows.cu
(built at first use by ops/_build.py), with no fallback. Each cut adds one
to the counter "slice.windows" (trace.counters()), and each launch of the
kernel one to "launch.tile_windows" (parallel/mesh.launch_counts), inside a
captured graph once a replay.
"""

import ctypes
from dataclasses import dataclass
from typing import Dict, Union

import torch

from ..trace import count
from . import _build
from .segprog import WindowPlan

INT32_MIN = -(2 ** 31)
_I32 = torch.int32
_C = ctypes.c_void_p
_ARGTYPES = ([_C] + [ctypes.c_int] * 3 + [_C] + [ctypes.c_int] * 4 + [_C, ctypes.c_int]
             + [_C] * 3 + [ctypes.c_int, _C])
_MAX_VALUES = 32  # values a launch (csrc/tile_windows.cu kMaxValues)
_fns = {}


@dataclass(eq=False)
class SegTable:
    """A SegProgram's tables on the device: starts int32 [V, K] (the int64
    starts clipped to int32's range, which moves no search for a frame
    index) and each value [V, K] as the device holds it (u32 rides int64)."""

    starts: torch.Tensor
    values: Dict[str, torch.Tensor]


def tile_windows_ref(table: SegTable, plan: WindowPlan,
                     c0: Union[int, torch.Tensor]) -> dict:
    """Plain version of the cut (see the module's docstring)."""
    starts = table.starts
    V, K = starts.shape
    S, nt, tile = plan.S, plan.nt, plan.tile
    dev = starts.device
    ts = (torch.arange(nt, dtype=_I32, device=dev) * tile + c0).expand(V, nt).contiguous()
    total = torch.full((V, 1), plan.total, dtype=_I32, device=dev)
    cap = torch.searchsorted(starts, total).clamp_min(1)
    first = (torch.searchsorted(starts, ts, right=True) - 1).clamp_min(0)
    last = torch.minimum(torch.searchsorted(starts, ts + tile), cap)
    idx = first[:, :, None] + torch.arange(S, device=dev)  # [V, nt, S]
    flat = lambda i: i.reshape(V, nt * S)  # noqa: E731
    tb = torch.where(idx < last[:, :, None],
                     starts.gather(1, flat(idx.clamp_max(K - 1))).view(V, nt, S),
                     torch.full((), plan.total + 1, dtype=_I32, device=dev))
    tb[:, :, 0] = INT32_MIN
    iv = flat(torch.minimum(idx, last[:, :, None] - 1).clamp(0, K - 1))
    out = {"tb": tb}
    for name, v in table.values.items():
        out[name] = v.gather(1, iv).view(V, nt, S)
    return out


def _fn():
    fn = _fns.get("zt_tile_windows")
    if fn is None:
        fn = _build.library("tile_windows").zt_tile_windows
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fns["zt_tile_windows"] = fn
    return fn


def _refuse(starts, values, c0p):
    """Raise the ValueError that says why tile_windows_cuda refused its
    arguments: starts int32 [V, K] with K > 0 and every value [V, K] of 1,
    2, 4 or 8 bytes an element, contiguous on starts' CUDA device; c0 an int
    or int32 [1] there."""
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"tile_windows_cuda needs CUDA tensors, got starts on {dev}")
    if starts.dtype != _I32 or starts.dim() != 2 or starts.shape[1] < 1:
        raise ValueError(f"starts must be int32 [V, K > 0], got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    for name, t in (("starts", starts), *values.items(), *((("c0", c0p),) if c0p is not None
                                                            else ())):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, t in values.items():
        if t.shape != starts.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, starts "
                             f"{tuple(starts.shape)}")
        if t.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"{name} has {t.element_size()} bytes an element")
    if c0p is not None and (c0p.dtype != _I32 or tuple(c0p.shape) != (1,)):
        raise ValueError(f"c0 must be int32 [1], got {c0p.dtype} {tuple(c0p.shape)}")
    raise ValueError("tile_windows_cuda refused its arguments")


def tile_windows_cuda(table: SegTable, plan: WindowPlan,
                      c0: Union[int, torch.Tensor]) -> dict:
    """The kernel, one launch for "tb" and every value (up to 32 values a
    launch; csrc/tile_windows.cu). c0: an int, or int32 [1] on the device
    (read by the kernel: a captured graph's chunk)."""
    starts, values = table.starts, table.values
    c0p = c0 if isinstance(c0, torch.Tensor) else None
    d = starts.get_device()
    if not (d >= 0 and starts.dtype is _I32 and starts.dim() == 2 and starts.shape[1] > 0
            and starts.is_contiguous()
            and all(v.get_device() == d and v.shape == starts.shape and v.is_contiguous()
                    and v.element_size() in (1, 2, 4, 8) for v in values.values())
            and (c0p is None or (c0p.get_device() == d and c0p.dtype is _I32
                                 and c0p.shape == (1,)))):
        _refuse(starts, values, c0p)
    V, K = starts.shape
    S, nt = plan.S, plan.nt
    tb = starts.new_empty((V, nt, S))
    out = {"tb": tb}
    for name, v in values.items():
        out[name] = v.new_empty((V, nt, S))
    n = len(values)
    srcs = (_C * max(n, 1))(*(v.data_ptr() for v in values.values()))
    dsts = (_C * max(n, 1))(*(out[name].data_ptr() for name in values))
    sizes = (ctypes.c_int * max(n, 1))(*(v.element_size() for v in values.values()))
    err = _fn()(starts.data_ptr(), V, K, 0 if c0p is not None else int(c0),
                None if c0p is None else c0p.data_ptr(), plan.total, nt, plan.tile, S,
                tb.data_ptr(), n, srcs, dsts, sizes, d,
                torch._C._cuda_getCurrentRawStream(d))
    if err != 0:
        raise RuntimeError(f"tile_windows kernel launch failed: cudaError_t {err}")
    if V and nt:
        count("launch.tile_windows", -(-max(n, 1) // _MAX_VALUES))
    return out


def tile_windows(table: SegTable, plan: WindowPlan, c0: Union[int, torch.Tensor]) -> dict:
    """The chunk's tiled slice: the plain version for CPU tensors, one
    launch of the CUDA kernel for CUDA tensors."""
    if table.starts.device.type == "cpu":
        out = tile_windows_ref(table, plan, c0)
    else:
        out = tile_windows_cuda(table, plan, c0)
    count("slice.windows")
    return out
