"""Segment programs: host tables sliced per render chunk, evaluated on the
device (port of zang_tpu/ops/segprog.py).

Two chunk formats, as in the JAX package:
- tiled: {"tb": [V, nt, S] i32, name: [V, nt, S]} (chunkify_tiled), a
  chunk that is a whole number of 512-frame tiles; per-tile selects;
- flat: {"starts": [V, Kc] i32, name: [V, Kc]} (chunkify), any chunk;
  masked delta sums over the chunk's segments (ops/scan.pconst_multi).

chunkify and chunkify_tiled are numpy twins of zang_tpu.ops.segprog's
(that module imports jax); their arrays are bit-identical.
"""

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .scan import pconst_multi


@dataclass
class SegProgram:
    """starts: [V, K] int64 sorted per voice; values: {name: [V, K]}."""

    starts: np.ndarray
    values: Dict[str, np.ndarray]


@dataclass
class ChunkedSegProgram:
    """Per-chunk slices: starts [n_chunks, V, Kc] int32, values {name:
    [n_chunks, V, Kc]}."""

    starts: np.ndarray
    values: Dict[str, np.ndarray]


def chunkify(sp: SegProgram, chunk_size: int, n_chunks: int, total: int) -> ChunkedSegProgram:
    """Per (chunk, voice): the segment covering the chunk start plus all
    segments starting inside the chunk, padded to the largest count with
    start = total (never selected) and repeated values (zero delta)."""
    V, K = sp.starts.shape
    c0s = np.arange(n_chunks, dtype=np.int64) * chunk_size
    firsts = np.empty((n_chunks, V), dtype=np.int64)
    lasts = np.empty((n_chunks, V), dtype=np.int64)
    for v in range(V):
        s = sp.starts[v]
        firsts[:, v] = np.maximum(np.searchsorted(s, c0s, side="right") - 1, 0)
        lasts[:, v] = np.searchsorted(s, c0s + chunk_size, side="left")
        # boundaries at/after `total` only touch the trimmed tail; keeping
        # them would put the padding into the final chunk's window and set
        # the count Kc for every chunk
        lasts[:, v] = np.minimum(
            lasts[:, v], max(np.searchsorted(s, total, side="left"), 1)
        )
    counts = np.maximum(lasts - firsts, 1)
    Kc = int(counts.max())
    idx = firsts[:, :, None] + np.arange(Kc)[None, None, :]  # [nc, V, Kc]
    in_window = idx < lasts[:, :, None]
    idx_vals = np.minimum(np.maximum(idx, 0), np.maximum(lasts - 1, 0)[:, :, None])
    idx_vals = np.minimum(idx_vals, K - 1)
    vix = np.arange(V)[None, :, None]
    starts_c = np.where(
        in_window, sp.starts[vix, np.minimum(idx, K - 1)], np.int64(total)
    )
    values_c = {name: arr[vix, idx_vals] for name, arr in sp.values.items()}
    return ChunkedSegProgram(starts=starts_c.astype(np.int32), values=values_c)


def eval_chunk(chunk_prog: dict, t_idx: torch.Tensor) -> dict:
    """Evaluate one chunk's program slice at t_idx [n] -> {name: [V, n]}, in
    either format: tiled ("tb": per-tile selects, t_idx one whole
    tile-aligned chunk) or flat ("starts": masked delta sums)."""
    if "tb" in chunk_prog:
        return eval_tiled_chunk(chunk_prog, t_idx)
    values = {k: v for k, v in chunk_prog.items() if k != "starts"}
    return pconst_multi(chunk_prog["starts"], values, t_idx)


def chunkify_tiled(
    sp: SegProgram, chunk_size: int, n_chunks: int, total: int, tile: int = 512
) -> dict:
    """Per (chunk, voice, tile): the segment covering the tile start plus
    all segments starting inside the tile.

    Returns {"tb": [nc, V, nt, S] i32 (boundary starts; slot 0 always
    active), name: [nc, V, nt, S], ...}."""
    if chunk_size % tile:
        raise ValueError(f"chunk_size {chunk_size} is not a multiple of tile {tile}")
    V, K = sp.starts.shape
    nt = chunk_size // tile
    tile_starts = (
        np.arange(n_chunks, dtype=np.int64)[:, None] * chunk_size
        + np.arange(nt, dtype=np.int64)[None, :] * tile
    ).reshape(-1)  # [nc * nt]
    firsts = np.empty((V, tile_starts.size), dtype=np.int64)
    lasts = np.empty((V, tile_starts.size), dtype=np.int64)
    for v in range(V):
        s = sp.starts[v]
        firsts[v] = np.maximum(np.searchsorted(s, tile_starts, side="right") - 1, 0)
        lasts[v] = np.searchsorted(s, tile_starts + tile, side="left")
        # boundaries at/after `total` only touch the trimmed tail; keeping
        # them would set the slot count S for every chunk
        lasts[v] = np.minimum(
            lasts[v], max(np.searchsorted(s, total, side="left"), 1)
        )
    counts = np.maximum(lasts - firsts, 1)
    S = int(counts.max())
    idx = firsts[:, :, None] + np.arange(S)[None, None, :]  # [V, nc*nt, S]
    in_window = idx < lasts[:, :, None]
    idx_v = np.minimum(np.maximum(np.minimum(idx, lasts[:, :, None] - 1), 0), K - 1)
    vix = np.arange(V)[:, None, None]
    tb = np.where(
        in_window,
        sp.starts[vix, np.minimum(idx, K - 1)],
        np.int64(total) + 1,
    )
    tb[:, :, 0] = -(2 ** 31)  # slot 0 covers the tile start
    out = {
        "tb": tb.reshape(V, n_chunks, nt, S).swapaxes(0, 1).astype(np.int32)
    }
    for name, arr in sp.values.items():
        vals = arr[vix, idx_v]
        out[name] = np.ascontiguousarray(
            vals.reshape(V, n_chunks, nt, S).swapaxes(0, 1)
        )
    return out


def eval_tiled_chunk(chunk_prog: dict, t_idx: torch.Tensor) -> dict:
    """Evaluate a tiled chunk slice ({"tb": [V, nt, S], ...}) over one whole
    tile-aligned chunk (t_idx [n]). Returns {name: [V, n]}: per sample,
    the value of the last slot j (in slot order) with t >= tb[j]."""
    tb = chunk_prog["tb"]
    V, nt, S = tb.shape
    n = t_idx.shape[0]
    if n % nt:
        raise ValueError(f"chunk of {n} frames does not split into {nt} tiles")
    tile = n // nt
    t = t_idx.reshape(nt, tile)
    values = {k: v for k, v in chunk_prog.items() if k != "tb"}
    out = {name: v[:, :, 0:1].expand(V, nt, tile) for name, v in values.items()}
    for j in range(1, S):
        mask = t[None, :, :] >= tb[:, :, j][:, :, None]  # [V, nt, tile]
        for name, v in values.items():
            out[name] = torch.where(mask, v[:, :, j][:, :, None], out[name])
    return {name: o.reshape(V, n) for name, o in out.items()}
