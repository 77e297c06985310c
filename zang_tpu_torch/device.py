"""Explicit device selection: nothing in the port picks a device by itself."""

import torch


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
