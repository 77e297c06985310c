"""Sampler: WAV playback with resampling and looping (port of
zang_tpu/ops/sampler.py; Sampler.zig).

The host decodes the raw PCM once into an f32 table (u8 -> (x-127.5)/127.5,
s16/s24/s32 -> x / 2^(bits-1)) and compiles the playback position into a
span-granular segment program: the position advances per paint span with
f32 arithmetic and wraps at the *byte* length when looping (the
reference's quirk, Sampler.zig:132-134). decode_wav_channel and
plan_sampler are copies of the JAX package's numpy code, bit for bit. The
device evaluates t_i = t0_span + i*ratio and reads two taps with the
reference's inverted interpolation weights (Sampler.zig:119-125).

A chunk is rendered one of two ways. The tiled chunk format goes through
sampler_play: the whole chunk (its program's slots, the position, the
wrap, both taps and the lerp) in one launch of the CUDA kernel
ops/lookup.sampler_play_cuda for CUDA tensors, its plain version
sampler_play_ref (eval_tiled_chunk, then eval_sampler) for CPU ones. The
flat format evaluates its program with segprog.eval_chunk and calls
eval_sampler, whose taps are one launch of ops/lookup.sampler_taps.
"""

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.timeline import SubvoiceTimeline
from ..core.wav import WavData
from . import lookup
from .scan import as_f32
from .segprog import SegProgram, eval_tiled_chunk

F32 = np.float32


@dataclass
class SampleTable:
    """Decoded sample: one channel, float32, plus the reference's metadata."""

    data_f32: np.ndarray  # [num_samples]
    num_samples: int
    byte_len: int  # raw data byte length (loop-wrap uses this, quirk)
    sample_rate: float


def decode_wav_channel(w: WavData, channel: int) -> SampleTable:
    raw = np.frombuffer(w.data, dtype=np.uint8)
    bits = w.bits_per_sample
    ch = w.num_channels
    if channel >= ch:
        data = np.zeros(0, dtype=np.float32)
    elif bits == 8:
        data = (raw.astype(np.float32) - F32(127.5)) / F32(127.5)
        data = data[channel::ch]
    elif bits == 16:
        v = np.frombuffer(w.data, dtype="<i2")[channel::ch]
        data = v.astype(np.float32) / F32(32768.0)
    elif bits == 24:
        b = raw.reshape(-1, 3)
        v = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        v = np.where(v >= 1 << 23, v - (1 << 24), v)[channel::ch]
        data = v.astype(np.float32) / F32(8388608.0)
    elif bits == 32:
        v = np.frombuffer(w.data, dtype="<i4")[channel::ch]
        data = v.astype(np.float32) / F32(2147483648.0)
    else:
        raise ValueError(f"unsupported bits {bits}")
    return SampleTable(
        data_f32=np.ascontiguousarray(data),
        num_samples=len(data),
        byte_len=len(w.data),
        sample_rate=float(w.sample_rate),
    )


def plan_sampler(
    tl: SubvoiceTimeline,
    sample: SampleTable,
    sample_rate: float,
    loop: bool,
    block_size: int = 1024,
) -> SegProgram:
    """Compile one subvoice's playback positions into a segment program.

    Values per span segment: t0 (f32 position at span start), mode
    (0 silent, 1 resample, 2 copy fast path).
    """
    ratio = F32(F32(sample.sample_rate) / F32(sample_rate))
    fast = 0.9999 < float(ratio) < 1.0001
    backwards_no_loop = float(ratio) < 0.0 and not loop

    seg_starts: List[int] = [0]
    t0s: List[float] = [0.0]
    modes: List[int] = [0]

    t = F32(0.0)
    total = tl.total
    K = len(tl.starts)
    for k in range(K):
        s = int(tl.starts[k])
        e = int(tl.starts[k + 1]) if k + 1 < K else total
        if bool(tl.resets[k]):
            t = F32(0.0)
        # walk block-aligned spans inside the segment (paint-call granularity)
        pos = s
        while pos < e:
            span_end = min(e, (pos // block_size + 1) * block_size)
            n = span_end - pos
            if backwards_no_loop:
                seg_starts.append(pos)
                t0s.append(float(t))
                modes.append(0)
            elif fast:
                seg_starts.append(pos)
                # Zig std.math.round: half away from zero (not banker's)
                t0s.append(float(np.sign(t) * np.floor(np.abs(t) + F32(0.5))))
                modes.append(2)
                t = F32(t + F32(n))
            else:
                seg_starts.append(pos)
                t0s.append(float(t))
                modes.append(1)
                t = F32(t + F32(F32(n) * ratio))
            if t >= F32(sample.byte_len) and loop:
                t = F32(t - F32(sample.byte_len))
            pos = span_end

    starts = np.array(seg_starts, dtype=np.int64)[None, :]
    values = {
        "t0": np.array(t0s, dtype=np.float32)[None, :],
        "mode": np.array(modes, dtype=np.int32)[None, :],
        "seg_start": np.array(seg_starts, dtype=np.int32)[None, :],
    }
    return SegProgram(starts=starts, values=values)


def eval_sampler(
    vals: dict,
    t_idx: torch.Tensor,
    table: torch.Tensor,
    num_samples: int,
    ratio: float,
    loop: bool,
    taps=None,
) -> torch.Tensor:
    """Device: per-sample playback from evaluated program values (t0, mode,
    seg_start, each [V, n]). table: f32 [num_samples] on t_idx's device.

    The two taps are read through `taps` (default ops.lookup.sampler_taps,
    which wraps or clips their indices: one launch of the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors)."""
    dt = (t_idx[None, :] - vals["seg_start"]).to(torch.float32)
    mode = vals["mode"]
    if num_samples == 0:
        return torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)

    # resample path (Sampler.zig:115-130): t = t0 + i*ratio, 2-tap inverted lerp
    t = vals["t0"] + dt * as_f32(ratio, dt)
    it0 = torch.floor(t).to(torch.int32)
    tfrac = (it0 + 1).to(torch.float32) - t
    ifast = vals["t0"].to(torch.int32) + dt.to(torch.int32)

    # one lookup serves the first tap of the resample and the copy (fast)
    # modes (their indices are program-span disjoint); the second only
    # matters in resample mode (Sampler.zig:105-130)
    tap_a, tap_b = (taps or lookup.sampler_taps)(torch.where(mode == 2, ifast, it0),
                                                 it0 + 1, table, num_samples, loop)
    s_re = tap_a * (1.0 - tfrac) + tap_b * tfrac
    zero = torch.zeros((), dtype=torch.float32, device=dt.device)
    return torch.where(mode == 1, s_re, torch.where(mode == 2, tap_a, zero))


def sampler_play_ref(prog: dict, t_idx: torch.Tensor, table: torch.Tensor,
                     num_samples: int, ratio: float, loop: bool) -> torch.Tensor:
    """Plain version of sampler_play on any device: the chunk's tiled
    program ({"tb", "t0", "mode", "seg_start"}, each [V, nt, S]) evaluated
    at t_idx [n] by eval_tiled_chunk, then eval_sampler with the plain taps.
    Returns f32 [V, n]."""
    return eval_sampler(eval_tiled_chunk(prog, t_idx), t_idx, table, num_samples, ratio,
                        loop, taps=lookup.sampler_taps_ref)


def sampler_play(prog: dict, t_idx: torch.Tensor, table: torch.Tensor,
                 num_samples: int, ratio: float, loop: bool) -> torch.Tensor:
    """The sampler's chunk from its tiled program, f32 [V, n]: the plain
    version for CPU tensors, one launch of the CUDA kernel for CUDA tensors
    (ops/lookup.sampler_play_cuda), which raises for anything else."""
    if not t_idx.is_cuda and t_idx.device.type == "cpu":
        return sampler_play_ref(prog, t_idx, table, num_samples, ratio, loop)
    return lookup.sampler_play_cuda(prog, t_idx, table, num_samples, ratio, loop)
