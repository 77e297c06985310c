"""Sample-table lookups (port of zang_tpu/ops/pallas_lookup.py and of the
wrap around it in zang_tpu/ops/sampler.py _pallas_taps).

  table_lookup(idx, sel, table)   sel * table[idx], 0 where idx is outside
                                  [0, N): the TPU kernel's function
  sampler_taps(idx_a, idx_b, table, num_samples, loop)
                                  the sampler's two taps of a chunk, each
                                  index wrapped (loop) or clipped (one shot)
                                  as _pallas_taps does it, in one launch
  sampler_play_cuda(prog, t_idx, table, num_samples, ratio, loop)
                                  the sampler's whole chunk from its tiled
                                  program in one launch (its plain version
                                  and router are ops/sampler.py's
                                  sampler_play_ref and sampler_play)

Each has a plain version (table_lookup_ref, sampler_taps_ref) that runs on
any device and that the router takes for CPU tensors; for CUDA tensors it
launches the hand-written kernel csrc/table_lookup.cu (built at first use
by ops/_build.py), with no fallback. The counter "launch.table_lookup"
(trace.counters()) counts that kernel's launches from every entry;
"launch.sampler_play" those of sampler_play_cuda alone.
"""

import ctypes

import torch

from ..trace import count
from . import _build

# the slots of a tile sampler_play_cuda takes: 16 bytes each in a block's 48 KB
# of shared memory (a tile of 512 frames has at most 514)
PLAY_MAX_SLOTS = 3072

_C = ctypes.c_void_p
_ARGTYPES = {
    "zt_table_lookup": [_C] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [_C],
    "zt_sampler_taps": [_C] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [_C],
    "zt_sampler_play": [_C] * 7 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                        ctypes.c_float] + [ctypes.c_int] * 2
                       + [_C],
}
_fns = {}  # C entry name -> ctypes function, typed on first use
_I32, _F32 = torch.int32, torch.float32


def table_lookup_ref(idx: torch.Tensor, sel: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Plain version: sel * table[idx], 0 where idx is out of range."""
    n = table.shape[0]
    ok = (idx >= 0) & (idx < n)
    v = table[torch.clamp(idx, 0, max(n - 1, 0)).long()]
    return sel * torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=v.device))


def sampler_taps_ref(idx_a: torch.Tensor, idx_b: torch.Tensor, table: torch.Tensor,
                     num_samples: int, loop: bool) -> torch.Tensor:
    """Plain version of sampler_taps: [2, *idx_a.shape], tap a then tap b.
    Looped: table[idx mod N] (torch.remainder: in [0, N) for the negative
    indices of reverse play). One shot: table[clip(idx, 0, N - 1)] times
    sel, 1 inside [0, N) and 0 outside."""
    idx = torch.stack((idx_a, idx_b))
    if loop:
        sel = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
        idx = torch.remainder(idx, num_samples)
    else:
        sel = ((idx >= 0) & (idx < num_samples)).to(torch.float32)
        idx = torch.clamp(idx, 0, num_samples - 1)
    return table_lookup_ref(idx, sel, table)


def _fn(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("table_lookup"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name, device, *args):
    """Call the C entry `name` on the current stream of CUDA device
    `device` (an index; the entry makes it current for the launch); raise
    if the launch fails."""
    err = _fn(name)(*args, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"table_lookup kernel launch failed ({name}): cudaError_t {err}")


def _refuse(entry, tensors, same_shape, table, num_samples=None, more=()):
    """Raise the ValueError that says why `entry` refused its arguments:
    tensors are (name, tensor, dtype), each to be contiguous on the first
    one's CUDA device; same_shape names whose shapes must agree; table f32
    [N], 0 < N < 2^31, N == num_samples when that is given; more: further
    (holds, what it asks) pairs."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{entry} needs CUDA tensors, got {tensors[0][0]} on {dev}")
    for name, t, dtype in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    shapes = {name: tuple(t.shape) for name, t, _ in tensors}
    a = same_shape[0]
    for b in same_shape[1:]:
        if shapes[a] != shapes[b]:
            raise ValueError(f"{b} has shape {shapes[b]}, {a} {shapes[a]}")
    if table.dim() != 1 or not 0 < table.shape[0] < 2 ** 31:
        raise ValueError(f"table must be [N] with 0 < N < 2^31, got {tuple(table.shape)}")
    if num_samples is not None and table.shape[0] != num_samples:
        raise ValueError(f"table has {table.shape[0]} samples, num_samples is {num_samples}")
    for holds, what in more:
        if not holds:
            raise ValueError(f"{entry}: {what}")
    raise ValueError(f"{entry} refused its arguments")


# The wrappers below are most of a call's cost at the sampler's shape (the
# kernel runs for ~2 us): the checks are one expression of cheap attribute
# reads, and _refuse says what failed only when one did.


def table_lookup_cuda(idx: torch.Tensor, sel: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """The kernel: idx int32 and sel f32 of one shape, table f32 [N], all
    contiguous on one CUDA device. Returns f32 of idx's shape."""
    d = idx.get_device()
    if not (d >= 0 and sel.get_device() == d == table.get_device()
            and idx.dtype is _I32 and sel.dtype is _F32 and table.dtype is _F32
            and idx.is_contiguous() and sel.is_contiguous() and table.is_contiguous()
            and idx.shape == sel.shape and table.dim() == 1
            and 0 < table.shape[0] < 2 ** 31):
        _refuse("table_lookup_cuda", (("idx", idx, _I32), ("sel", sel, _F32),
                                      ("table", table, _F32)), ("idx", "sel"), table)
    out = idx.new_empty(idx.shape, dtype=_F32)
    _launch("zt_table_lookup", d, idx.data_ptr(), sel.data_ptr(), table.data_ptr(),
            out.data_ptr(), idx.numel(), table.shape[0])
    count("launch.table_lookup")
    return out


def sampler_taps_cuda(idx_a: torch.Tensor, idx_b: torch.Tensor, table: torch.Tensor,
                      num_samples: int, loop: bool) -> torch.Tensor:
    """The kernel, one launch for both taps: idx_a and idx_b int32 of one
    shape, table f32 [num_samples], all contiguous on one CUDA device.
    Returns f32 [2, *idx_a.shape]."""
    d = idx_a.get_device()
    if not (d >= 0 and idx_b.get_device() == d == table.get_device()
            and idx_a.dtype is _I32 and idx_b.dtype is _I32 and table.dtype is _F32
            and idx_a.is_contiguous() and idx_b.is_contiguous() and table.is_contiguous()
            and idx_a.shape == idx_b.shape and table.shape == (num_samples,)
            and 0 < num_samples < 2 ** 31):
        _refuse("sampler_taps_cuda", (("idx_a", idx_a, _I32), ("idx_b", idx_b, _I32),
                                      ("table", table, _F32)), ("idx_a", "idx_b"), table,
                num_samples)
    out = idx_a.new_empty((2, *idx_a.shape), dtype=_F32)
    _launch("zt_sampler_taps", d, idx_a.data_ptr(), idx_b.data_ptr(), table.data_ptr(),
            out.data_ptr(), idx_a.numel(), num_samples, 1 if loop else 0)
    count("launch.table_lookup")
    return out


def sampler_play_cuda(prog: dict, t_idx: torch.Tensor, table: torch.Tensor,
                      num_samples: int, ratio: float, loop: bool) -> torch.Tensor:
    """The kernel, the sampler's chunk in one launch: prog the chunk's tiled
    program (tb, mode, seg_start int32 and t0 f32, each [V, nt, S] with
    S <= PLAY_MAX_SLOTS), t_idx int32 [n] with n a multiple of nt, table
    f32 [num_samples], all contiguous on one CUDA device; ratio the playback
    ratio as an f32 (passed as one). Returns f32 [V, n]: ops/sampler.py
    sampler_play_ref's bits. num_samples == 0 gives zeros, no launch."""
    tb, t0, mode, ss = prog["tb"], prog["t0"], prog["mode"], prog["seg_start"]
    d = t_idx.get_device()
    if num_samples == 0 and d >= 0:
        return t_idx.new_zeros((tb.shape[0], t_idx.shape[0]), dtype=_F32)
    if not (d >= 0 and tb.get_device() == t0.get_device() == mode.get_device()
            == ss.get_device() == table.get_device() == d
            and tb.dtype is _I32 and t0.dtype is _F32 and mode.dtype is _I32
            and ss.dtype is _I32 and t_idx.dtype is _I32 and table.dtype is _F32
            and tb.is_contiguous() and t0.is_contiguous() and mode.is_contiguous()
            and ss.is_contiguous() and t_idx.is_contiguous() and table.is_contiguous()
            and tb.dim() == 3 and tb.shape == t0.shape == mode.shape == ss.shape
            and t_idx.dim() == 1 and 0 < tb.shape[1] and 0 < tb.shape[2] <= PLAY_MAX_SLOTS
            and t_idx.shape[0] % tb.shape[1] == 0 and table.shape == (num_samples,)
            and 0 < num_samples < 2 ** 31):
        dims = tb.dim() == 3 and t_idx.dim() == 1
        _refuse("sampler_play_cuda", (("t_idx", t_idx, _I32), ("tb", tb, _I32),
                                      ("t0", t0, _F32), ("mode", mode, _I32),
                                      ("seg_start", ss, _I32), ("table", table, _F32)),
                ("tb", "t0", "mode", "seg_start"), table, num_samples,
                more=((dims, "tb must be [V, nt, S] and t_idx [n]"),
                      (dims and tb.shape[1] > 0 and t_idx.shape[0] % tb.shape[1] == 0,
                       "n must be a multiple of nt > 0"),
                      (dims and 0 < tb.shape[2] <= PLAY_MAX_SLOTS,
                       f"it takes 1 to {PLAY_MAX_SLOTS} slots a tile")))
    V, nt, S = tb.shape
    n = t_idx.shape[0]
    out = t_idx.new_empty((V, n), dtype=_F32)
    _launch("zt_sampler_play", d, tb.data_ptr(), t0.data_ptr(), mode.data_ptr(),
            ss.data_ptr(), t_idx.data_ptr(), table.data_ptr(), out.data_ptr(), V, nt, S, n,
            num_samples, ratio, 1 if loop else 0)
    count("launch.table_lookup")
    count("launch.sampler_play")
    return out


def table_lookup(idx: torch.Tensor, sel: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """sel * table[idx]: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if not idx.is_cuda and idx.device.type == "cpu":
        return table_lookup_ref(idx, sel, table)
    return table_lookup_cuda(idx, sel, table)


def sampler_taps(idx_a: torch.Tensor, idx_b: torch.Tensor, table: torch.Tensor,
                 num_samples: int, loop: bool) -> torch.Tensor:
    """The sampler's two taps, [2, *idx_a.shape]: the plain version for CPU
    tensors, one launch of the CUDA kernel for CUDA tensors."""
    if not idx_a.is_cuda and idx_a.device.type == "cpu":
        return sampler_taps_ref(idx_a, idx_b, table, num_samples, loop)
    return sampler_taps_cuda(idx_a, idx_b, table, num_samples, loop)
