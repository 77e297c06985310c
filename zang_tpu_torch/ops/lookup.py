"""Sample-table lookups (port of zang_tpu/ops/pallas_lookup.py and of the
wrap around it in zang_tpu/ops/sampler.py _pallas_taps).

  table_lookup(idx, sel, table)   sel * table[idx], 0 where idx is outside
                                  [0, N): the TPU kernel's function
  sampler_taps(idx_a, idx_b, table, num_samples, loop)
                                  the sampler's two taps of a chunk, each
                                  index wrapped (loop) or clipped (one shot)
                                  as _pallas_taps does it, in one launch

Each has a plain version (table_lookup_ref, sampler_taps_ref) that runs on
any device and that the router takes for CPU tensors; for CUDA tensors it
launches the hand-written kernel csrc/table_lookup.cu (both entries are
instances of one kernel body, built at first use by ops/_build.py), with
no fallback. table_lookup_launches counts that kernel's launches from
either entry.
"""

import ctypes

import torch

from . import _build

table_lookup_launches = 0

_C = ctypes.c_void_p
_ARGTYPES = {
    "zt_table_lookup": [_C] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [_C],
    "zt_sampler_taps": [_C] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [_C],
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


def _refuse(entry, tensors, same_shape, table, num_samples=None):
    """Raise the ValueError that says why `entry` refused its arguments:
    tensors are (name, tensor, dtype), each to be contiguous on the first
    one's CUDA device; same_shape two of the names whose shapes must agree;
    table f32 [N], 0 < N < 2^31, N == num_samples when that is given."""
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
    a, b = same_shape
    if shapes[a] != shapes[b]:
        raise ValueError(f"{b} has shape {shapes[b]}, {a} {shapes[a]}")
    if table.dim() != 1 or not 0 < table.shape[0] < 2 ** 31:
        raise ValueError(f"table must be [N] with 0 < N < 2^31, got {tuple(table.shape)}")
    if num_samples is not None and table.shape[0] != num_samples:
        raise ValueError(f"table has {table.shape[0]} samples, num_samples is {num_samples}")
    raise ValueError(f"{entry} refused its arguments")


# The wrappers below are most of a call's cost at the sampler's shape (the
# kernel runs for ~2 us): the checks are one expression of cheap attribute
# reads, and _refuse says what failed only when one did.


def table_lookup_cuda(idx: torch.Tensor, sel: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """The kernel: idx int32 and sel f32 of one shape, table f32 [N], all
    contiguous on one CUDA device. Returns f32 of idx's shape."""
    global table_lookup_launches
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
    table_lookup_launches += 1
    return out


def sampler_taps_cuda(idx_a: torch.Tensor, idx_b: torch.Tensor, table: torch.Tensor,
                      num_samples: int, loop: bool) -> torch.Tensor:
    """The kernel, one launch for both taps: idx_a and idx_b int32 of one
    shape, table f32 [num_samples], all contiguous on one CUDA device.
    Returns f32 [2, *idx_a.shape]."""
    global table_lookup_launches
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
    table_lookup_launches += 1
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
