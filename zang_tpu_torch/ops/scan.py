"""u32 phase arithmetic, the masked delta sum of flat segment tables and the
affine scan (port of zang_tpu/ops/scan.py).

u32 convention: torch has no add, sub, compare or shift on uint32 (on the
CPU each raises), so phase counters ride int64 tensors holding 0..2^32-1,
masked with U32 after every add, sub or mul. Comparisons of two masked
values are then the unsigned compares the oscillators need. CUDA kernels
use native uint32_t.
"""

from typing import Callable, Tuple

import numpy as np
import torch

U32 = 0xFFFFFFFF
F32 = torch.float32


def as_f32(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number or tensor as an f32 tensor on like's device. A
    number is filled in on the device (no copy from the host, so a CUDA
    graph can capture it), rounded to f32 as a copy would round it."""
    if isinstance(x, (int, float, np.integer, np.floating)):
        return torch.full((), float(np.float32(x)), dtype=F32, device=like.device)
    return torch.as_tensor(x, dtype=F32, device=like.device)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor into 0..2^32-1 (two's complement for negatives)."""
    return x & U32


def utof23(cnt: torch.Tensor) -> torch.Tensor:
    """u32 phase -> float in [0, 1) with 23-bit precision (PulseOsc.zig:19-21):
    the top 23 bits become a mantissa with exponent 0, minus 1."""
    bits = ((cnt >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(F32) - 1.0


def ftou32(v: torch.Tensor) -> torch.Tensor:
    """float [0, 1) -> 0.32 unsigned fixed point (PulseOsc.zig:23-25), as
    int64. The products stay f32, as in the reference."""
    return ((v * 4294967296.0) * 0.99995).to(torch.int64)


def freq_to_ifreq(freq: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Frequency (Hz, f32, may be negative) -> u32 phase increment, as int64.

    ifreq = u32(f32(2^32 / sr) * freq); a negative frequency maps to the
    two's complement of its magnitude (backward phase motion). A magnitude
    of 2^32 or more saturates at 2^32 - 1, as the JAX package's f32 -> u32
    conversion does."""
    srbase = np.float32(np.float32(4294967296.0) / np.float32(sample_rate))
    scaled = as_f32(freq, freq) * as_f32(srbase, freq)
    mag = torch.clamp(scaled.abs(), max=4294967296.0).to(torch.int64).clamp(max=U32)
    return u32(torch.where(scaled >= 0, mag, -mag))


def t_rows(t_idx: torch.Tensor) -> torch.Tensor:
    """Frame indices broadcastable against [V, n]: t_idx is [n] (the frames
    of every voice) or [V, n] (a row a voice: a fleet's lanes folded into the
    voice axis, each lane at its own frame, serve/live.py)."""
    return t_idx if t_idx.dim() == 2 else t_idx[None, :]


def pconst_multi(starts: torch.Tensor, values: dict, t_idx: torch.Tensor) -> dict:
    """Piecewise-constant segment tables evaluated at samples, gather-free
    (zang_tpu/ops/scan.py pconst_multi).

    starts: [V, K] int32, sorted per voice; values: {name: [V, K]} (f32,
    int32, or u32 riding int64); t_idx: [n] or [V, n] int32 (t_rows).
    Returns {name: [V, n]}.

    value(t) = sum_k [t >= starts_k] * (v_k - v_{k-1}), a masked delta sum
    unrolled over K in the JAX package's order: in f32 the sum of deltas is
    not v_k bit for bit, and the reference computes the sum. u32 values
    wrap mod 2^32, as the JAX package's uint32 arithmetic does. Padding
    entries need start > t_idx[-1] or a zero delta."""
    K = starts.shape[-1]
    out, deltas = {}, {}
    for name, v in values.items():
        d = torch.cat([v[:, :1], v[:, 1:] - v[:, :-1]], dim=1)
        deltas[name] = u32(d) if v.dtype == torch.int64 else d
        out[name] = torch.zeros((starts.shape[0], t_idx.shape[-1]), dtype=v.dtype,
                                device=v.device)
    zero = {name: torch.zeros((), dtype=v.dtype, device=v.device)
            for name, v in values.items()}
    t = t_rows(t_idx)
    for k in range(K):
        mask = t >= starts[:, k:k + 1]
        for name, d in deltas.items():
            out[name] = out[name] + torch.where(mask, d[:, k:k + 1], zero[name])
    # int64 sums of K u32 deltas cannot overflow: wrap once at the end
    return {name: u32(o) if o.dtype == torch.int64 else o for name, o in out.items()}


def _prepend(s0: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    head = s0[..., None].expand(*post.shape[:-1], 1)
    return torch.cat([head, post[..., :-1]], dim=-1)


def exclusive_cumsum_u32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum of u32 values (int64 tensors holding 0..2^32-1),
    wrapping mod 2^32 like the JAX package's uint32 cumsum. The int64
    running sum cannot overflow below 2^31 elements."""
    return u32(torch.cumsum(x, dim=dim) - x)


def _affine1_combine(x, y):
    a1, u1 = x
    a2, u2 = y
    return a2 * a1, a2 * u1 + u2


def affine1_scan(a: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 block: int = 512) -> torch.Tensor:
    """Scan of x_i = a_i * x_{i-1} + u_i (first-order recurrences).

    a, u: [..., n]; s0: [...]. Returns the post-states [..., n]. The same
    two levels as affine2_scan. For the decimator's latch (a in {0, 1},
    u in {x, 0}) every association order gives the same bits."""
    n = a.shape[-1]
    if n % block != 0 or n <= block:
        ai, ui = associative_scan(_affine1_combine, (a, u))
        return ai * s0[..., None] + ui
    nb = n // block
    ai, ui = associative_scan(_affine1_combine,
                              (a.reshape(*a.shape[:-1], nb, block),
                               u.reshape(*u.shape[:-1], nb, block)))
    sa, su = associative_scan(_affine1_combine, (ai[..., -1], ui[..., -1]))
    bl = sa * s0[..., None] + su  # state at each block's end
    start = _prepend(s0, bl)
    post = ai * start[..., :, None] + ui
    return post.reshape(*post.shape[:-2], n)


def _affine2_combine(x, y):
    """Compose two affine maps on 2-state systems: y after x.

    Elements are (a, b, c, d, e, f) for M = [[a, b], [c, d]], v = [e, f].
    Explicit elementwise arithmetic in the order of the JAX reference."""
    (a1, b1, c1, d1, e1, f1) = x
    (a2, b2, c2, d2, e2, f2) = y
    return (
        a2 * a1 + b2 * c1,
        a2 * b1 + b2 * d1,
        c2 * a1 + d2 * c1,
        c2 * b1 + d2 * d1,
        a2 * e1 + b2 * f1 + e2,
        c2 * e1 + d2 * f1 + f2,
    )


def _affine2_apply(m, lx, ly):
    a, b, c, d, e, f = m
    return a * lx + b * ly + e, c * lx + d * ly + f


def associative_scan(combine: Callable, elems: Tuple[torch.Tensor, ...]):
    """Inclusive scan along the last axis (Hillis-Steele: log2(n) levels of
    whole-tensor ops, no loop over samples). combine(earlier, later)."""
    n = elems[0].shape[-1]
    out = tuple(elems)
    shift = 1
    while shift < n:
        comb = combine(tuple(e[..., :-shift] for e in out),
                       tuple(e[..., shift:] for e in out))
        out = tuple(torch.cat([e[..., :shift], c], dim=-1)
                    for e, c in zip(out, comb))
        shift *= 2
    return out


def affine2_scan(elems, s0_l, s0_b, block: int = 512):
    """Scan of x_i = M_i x_{i-1} + v_i for 2-state recurrences.

    elems: (a, b, c, d, e, f), each [..., n]; s0_l/s0_b: [...].
    Returns (pre_l, pre_b, post_l, post_b), [..., n] states before/after
    each step. Two levels as in the reference: a scan within blocks of
    `block` samples, a scan over the block summaries, then an apply."""
    n = elems[0].shape[-1]
    if n % block != 0 or n <= block:
        inc = associative_scan(_affine2_combine, elems)
        post_l, post_b = _affine2_apply(inc, s0_l[..., None], s0_b[..., None])
    else:
        nb = n // block
        blocked = tuple(e.reshape(*e.shape[:-1], nb, block) for e in elems)
        inc = associative_scan(_affine2_combine, blocked)
        summaries = tuple(e[..., -1] for e in inc)  # [..., nb]
        sum_scan = associative_scan(_affine2_combine, summaries)
        bl, bb = _affine2_apply(sum_scan, s0_l[..., None], s0_b[..., None])
        start_l = _prepend(s0_l, bl)
        start_b = _prepend(s0_b, bb)
        post_l, post_b = _affine2_apply(inc, start_l[..., :, None],
                                        start_b[..., :, None])
        post_l = post_l.reshape(*post_l.shape[:-2], n)
        post_b = post_b.reshape(*post_b.shape[:-2], n)
    return _prepend(s0_l, post_l), _prepend(s0_b, post_b), post_l, post_b
