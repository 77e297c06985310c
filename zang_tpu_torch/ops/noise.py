"""Noise: white and pink (port of zang_tpu/ops/noise.py), on a threefry2x32
counter-based generator that reproduces jax.random's bit stream.

The JAX package draws its noise tape with jax.random.uniform from a
threefry key, and the examples fold the chunk's first frame into the key,
so the tape is a pure function of (seed, frame). To render the same audio
the port needs the same bits: threefry2x32 below is the Threefry-2x32 hash
(20 rounds) as jax/_src/prng.py applies it, with the counter layout of
`jax_threefry_partitionable=True` (the default of the JAX this port is held
to, 0.9): element i of a draw hashes the 64-bit counter i as (hi, lo) and
takes hi_out ^ lo_out. A key is a pair of Python ints (k1, k2): seeding and
fold_in run on the host, only the draw runs on the device.

u32 values ride int64 tensors masked to 32 bits (ops/scan.py). Plain torch
ops: jax.random is no hand-written kernel in the JAX package either.

Pink noise is Paul Kellett's 7-tap filter (Noise.zig:54-69): six one-pole
recurrences (affine1_scan) plus one pure delay tap. The reference never
writes the pink filter state back (Noise.zig:68), so its state restarts at
zero on every paint call; `reset_mask` (True where a paint call would have
begun) keeps that quirk, None gives the continuous filter.
"""

import math
from typing import Optional, Tuple

import torch

from .scan import U32, affine1_scan, utof23

Tensor = torch.Tensor
Key = Tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Kellett tap coefficients (Noise.zig:56-66)
_PINK_A = (0.99886, 0.99332, 0.96900, 0.86650, 0.55000, -0.7616)
_PINK_C = (0.0555179, 0.0750759, 0.1538520, 0.3104856, 0.5329522, -0.0168980)
_PINK_DIRECT = 0.5362
_PINK_DELAYED = 0.115926


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pair (x1, x2) under the key
    pair (k1, k2). Each is a Python int or an int64 tensor holding a u32;
    returns the pair of hashed words in the same form."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & U32
    x2 = (x2 + ks[1]) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & U32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & U32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & U32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & U32
    return x1, x2


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed): the seed's high and low 32 bits."""
    return (seed >> 32) & U32, seed & U32


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in(key, data): the hash of the counter (0, u32(data))."""
    return threefry2x32(key[0], key[1], 0, data & U32)


def random_bits(key: Key, shape, device) -> Tensor:
    """jax.random.bits(key, shape) as u32 in int64: element i (row-major)
    is hi ^ lo of the hashed 64-bit counter i."""
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError(f"a draw of {size} values needs the counter's high word")
    idx = torch.arange(size, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], 0, idx)
    return (b1 ^ b2).reshape(shape)


def uniform(key: Key, shape, device) -> Tensor:
    """jax.random.uniform(key, shape, float32), bit for bit: the top 23
    random bits as the mantissa of a float in [1, 2), minus 1."""
    return utof23(random_bits(key, shape, device))


def white_noise(key: Key, shape, device) -> Tuple[Tensor, Tensor]:
    """Uniform [0, 1) tape -> white noise in [-1, 1) (Noise.zig:48-51).
    Returns (white, tape)."""
    tape = uniform(key, shape, device)
    return tape * 2.0 - 1.0, tape


def pink_from_tape(tape: Tensor, b0: Optional[Tensor] = None,
                   reset_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Pink noise from a uniform [0, 1) tape [..., n].

    b0: [..., 7] initial tap states (zeros by default). reset_mask [..., n]:
    True where the tap states restart at zero (the reference's quirk).
    Returns (out [..., n], final tap states [..., 7])."""
    white = tape * 2.0 - 1.0
    if b0 is None:
        b0 = torch.zeros((*tape.shape[:-1], 7), dtype=torch.float32, device=tape.device)
    zero = torch.zeros((), dtype=torch.float32, device=tape.device)
    taps = []
    for k in range(6):
        a = torch.full_like(white, _PINK_A[k])
        if reset_mask is not None:
            a = torch.where(reset_mask, zero, a)
        taps.append(affine1_scan(a, white * _PINK_C[k], b0[..., k]))
    # b6: the previous sample's white * 0.115926 (applied before the update)
    delayed = white * _PINK_DELAYED
    b6_prev = torch.cat([b0[..., 6:7], delayed[..., :-1]], dim=-1)
    if reset_mask is not None:
        b6_prev = torch.where(reset_mask, zero, b6_prev)
    out = (taps[0] + taps[1] + taps[2] + taps[3] + taps[4] + taps[5]
           + b6_prev + white * _PINK_DIRECT)
    finals = [t[..., -1] for t in taps] + [delayed[..., -1]]
    return out, torch.stack(finals, dim=-1)
