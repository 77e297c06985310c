"""Sample-table lookup: out = sel * table[idx] (port of
zang_tpu/ops/pallas_lookup.py, the sampler's taps).

table_lookup_ref is the plain version, on any device. table_lookup takes
it for CPU tensors; for CUDA tensors it launches the hand-written kernel
csrc/table_lookup.cu (built at first use, ops/_build.py), with no
fallback. table_lookup_launches counts the kernel's launches.

An index outside [0, N) gives 0 (times sel), as the TPU kernel's one-hot
selects nothing for it.
"""

import ctypes

import torch

from . import _build

table_lookup_launches = 0

_C = ctypes.c_void_p


def table_lookup_ref(idx: torch.Tensor, sel: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Plain version: sel * table[idx], 0 where idx is out of range."""
    n = table.shape[0]
    ok = (idx >= 0) & (idx < n)
    v = table[torch.clamp(idx, 0, max(n - 1, 0)).long()]
    return sel * torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _lib():
    lib = _build.library("table_lookup")
    fn = lib.zt_table_lookup
    if fn.argtypes is None:
        fn.argtypes = [_C] * 4 + [ctypes.c_longlong, ctypes.c_int, _C]
        fn.restype = ctypes.c_int
    return lib


def table_lookup_cuda(idx: torch.Tensor, sel: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """The kernel: idx int32 and sel f32 of one shape, table f32 [N], all
    contiguous on one CUDA device. Returns f32 of idx's shape."""
    global table_lookup_launches
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"table_lookup_cuda needs CUDA tensors, got idx on {dev}")
    for name, t, dtype in (("idx", idx, torch.int32), ("sel", sel, torch.float32),
                           ("table", table, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if sel.shape != idx.shape:
        raise ValueError(f"sel has shape {tuple(sel.shape)}, idx {tuple(idx.shape)}")
    if table.dim() != 1 or not 0 < table.shape[0] < 2 ** 31:
        raise ValueError(f"table must be [N] with 0 < N < 2^31, got {tuple(table.shape)}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().zt_table_lookup(idx.data_ptr(), sel.data_ptr(), table.data_ptr(),
                                     out.data_ptr(), idx.numel(), table.shape[0],
                                     stream)
    if err != 0:
        raise RuntimeError(f"table_lookup kernel launch failed: cudaError_t {err}")
    table_lookup_launches += 1
    return out


def table_lookup(idx: torch.Tensor, sel: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """sel * table[idx]: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if idx.device.type == "cpu":
        return table_lookup_ref(idx, sel, table)
    return table_lookup_cuda(idx, sel, table)
