"""Delay lines and echo effects (port of zang_tpu/ops/delay.py).

The reference's Delay is a ring buffer read and written in chunks no
longer than the delay (delay.zig:28-89); any such chunking delays by
exactly D samples, which these forms use:

- simple_delay (no feedback, modules.zig:341-384): a pure shift; the state
  is the last D input samples.
- filtered_echoes (feedback through a lowpass, modules.zig:388-462):
  sequential at the granularity of the delay. The JAX package's lax.scan
  over sub-chunks of s <= D samples is a host loop here; the buffer is
  held "rolled", so the read is always its head.
- stereo_echoes (modules.zig:464-525): the two composed.
"""

from typing import Tuple

import torch

from . import filters
from .scan import as_f32

Tensor = torch.Tensor


def simple_delay(state: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
    """Delay x [..., n] by D = state.shape[-1] samples (any n).
    state: the last D inputs. Returns (new_state, out)."""
    n = x.shape[-1]
    full = torch.cat([state, x], dim=-1)
    return full[..., n:], full[..., :n]


def _sub_chunk(n: int, delay: int) -> int:
    """Largest n / 2^k that is <= delay (the feedback granularity)."""
    s = n
    while s > delay:
        if s % 2:
            raise ValueError(
                f"chunk {n} not divisible into sub-chunks <= delay {delay}")
        s //= 2
    return s


def filtered_echoes(state: dict, x: Tensor, feedback_volume, cutoff,
                    delay: int) -> Tuple[dict, Tensor]:
    """Feedback echo: out = lowpass(x + feedback_volume * delayed(out)).

    state: {"buf": [..., D], "l": [...], "b": [...]}; x: [..., n]. Per
    sub-chunk, as the reference loop (modules.zig:420-458): read the
    feedback, scale, add the input, lowpass (res 0, the plain svf_filter:
    the JAX package runs no Pallas kernel on this 1-D call), emit, write
    back into the delay."""
    n = x.shape[-1]
    s = _sub_chunk(n, state["buf"].shape[-1])
    buf, l, b = state["buf"], state["l"], state["b"]
    fbv = as_f32(feedback_volume, x)
    outs = []
    for i in range(n // s):
        mixed = buf[..., :s] * fbv + x[..., i * s:(i + 1) * s]
        l, b, filtered = filters.svf_filter(l, b, mixed, "low_pass", cutoff, 0.0)
        buf = torch.cat([buf[..., s:], filtered], dim=-1)
        outs.append(filtered)
    return {"buf": buf, "l": l, "b": b}, torch.cat(outs, dim=-1)


def stereo_echoes_init(main_delay: int, device, lead_shape=()) -> dict:
    half = main_delay // 2

    def z(*shape):
        return torch.zeros((*lead_shape, *shape), dtype=torch.float32, device=device)

    return {
        "delay0": z(half),
        "delay1": z(half),
        "echo": {"buf": z(main_delay), "l": z(), "b": z()},
    }


def stereo_echoes(state: dict, x: Tensor, feedback_volume,
                  cutoff) -> Tuple[dict, Tensor]:
    """Dry centre plus mirrored L/R filtered echoes. x: [..., n] mono.
    Returns (state, stereo [..., 2, n])."""
    d0, pre = simple_delay(state["delay0"], x)
    echo_state, echoed = filtered_echoes(
        state["echo"], pre, feedback_volume, cutoff, state["echo"]["buf"].shape[-1])
    d1, mirrored = simple_delay(state["delay1"], echoed)
    out = torch.stack([x + echoed, x + mirrored], dim=-2)
    return {"delay0": d0, "delay1": d1, "echo": echo_state}, out
