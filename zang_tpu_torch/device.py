"""Explicit device selection: nothing in the port picks a device by itself.
And the one rule for an array's dtype on a device: u32 rides int64 (torch
has no u32 arithmetic, ops/scan.py)."""

import numpy as np
import torch

from .trace import count
from .tree import tree_map

_WIDER = {np.dtype(np.uint32): np.dtype(np.int64)}  # numpy dtype -> the device's
_DTYPES = {}  # numpy dtype -> the device's torch dtype, as found


def require_device(name) -> torch.device:
    """torch.device for `name` ("cpu", "cuda", "cuda:0", ...).

    Raises when CUDA is asked for and this process has none — the port has
    no silent CPU fallback."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cpu or cuda)")
    return dev


def device_numpy(a: np.ndarray) -> np.ndarray:
    """a in the dtype the device holds it in (a u32 array as int64)."""
    wide = _WIDER.get(a.dtype)
    return a if wide is None else a.astype(wide)


def device_dtype(a) -> torch.dtype:
    """The dtype a numpy array (or a tensor) has on the device."""
    if isinstance(a, torch.Tensor):
        return a.dtype
    d = _DTYPES.get(a.dtype)
    if d is None:
        wide = _WIDER.get(a.dtype, a.dtype)
        d = _DTYPES[a.dtype] = torch.from_numpy(np.empty(0, wide)).dtype
    return d


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """a on `device` in its device dtype; counts one "h2d.copies"."""
    count("h2d.copies")
    return torch.from_numpy(np.ascontiguousarray(device_numpy(a))).to(device)


def arrays_to_device(tree, device):
    """tree with every numpy array put on `device` (to_device)."""
    return tree_map(lambda a: to_device(a, device), tree, leaf=np.ndarray)
