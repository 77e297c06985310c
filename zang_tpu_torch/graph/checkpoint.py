"""Checkpoint/resume for long renders (a port of zang_tpu/graph/checkpoint.py).

Render state is a tree of small tensors (phase counters, filter l/b, delay
lines), so a render can be checkpointed between segments of chunks and
resumed bit-exactly: the chunked design makes the continuation identical
to an uninterrupted render.

The file is the JAX package's `.npz` layout: `chunk_index`, `audio` (the
chunks rendered so far, [C, chunk_index * chunk]) and the state's leaves
as `leaf_0`, `leaf_1`, ... in the JAX package's pytree order (dict entries
by sorted key, lists and tuples in order; None and () hold none). So either
package's file loads into the other's state of the same Performance; a u32
leaf the JAX package wrote comes back as the port's int64 (ops/scan.py).
"""

import os

import numpy as np
import torch

from ..device import device_numpy, require_device
from .render import Performance, chunk_slice, make_stream_step


def state_leaves(state) -> list:
    """The state's tensors in the JAX package's pytree order. Its own walk,
    not tree.tree_leaves: dict entries go by sorted key, as the file's
    layout and the JAX package's pytrees have them."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in state_leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in state_leaves(v)]
    if state is None:
        return []
    return [state]


def _unflatten(template, leaves):
    """template's tree with its leaves taken in order from the iterator."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if template is None:
        return None
    return next(leaves)


def _as_leaf(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {a.shape}, the state's is "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(np.ascontiguousarray(device_numpy(a))).to(device=like.device,
                                                                       dtype=like.dtype)


def save_checkpoint(path: str, chunk_index: int, state, audio_so_far: np.ndarray):
    leaves = [x.detach().cpu().numpy() for x in state_leaves(state)]
    np.savez_compressed(
        path,
        chunk_index=np.int64(chunk_index),
        audio=audio_so_far,
        **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
    )


def load_checkpoint(path: str, state_template):
    """(chunk_index, state, audio): the state in state_template's tree, each
    leaf on its template leaf's device and in its dtype. Raises when the
    file's leaves do not fit the template."""
    z = np.load(path)
    like = state_leaves(state_template)
    n = 0
    while f"leaf_{n}" in z:
        n += 1
    if n != len(like):
        raise ValueError(f"{path}: {n} state leaves, the performance's state has "
                         f"{len(like)}")
    leaves = [_as_leaf(z[f"leaf_{i}"], t) for i, t in enumerate(like)]
    state = _unflatten(state_template, iter(leaves))
    return int(z["chunk_index"]), state, z["audio"]


def render_resumable(
    perf: Performance,
    total_frames: int,
    checkpoint_path: str,
    chunk_size: int = 65536,
    segment_chunks: int = 32,
    resume: bool = True,
    *,
    device="cuda",
) -> np.ndarray:
    """Render on `device` (the card unless the caller asks for the CPU) with
    a checkpoint after every segment of segment_chunks chunks; resumes from
    checkpoint_path if it exists (a file of either package). Returns f32
    [C, total_frames] on the host, bit-identical to an uninterrupted
    render_performance call with the same chunk size."""
    dev = require_device(device)
    xs, n_chunks = perf.chunk_xs(total_frames, chunk_size)
    step = make_stream_step(perf, chunk_size, device=dev)

    state = perf.init_state(dev)
    start_chunk = 0
    segments = []
    if resume and os.path.exists(checkpoint_path):
        start_chunk, state, audio = load_checkpoint(checkpoint_path, state)
        segments.append(audio)

    c = start_chunk
    while c < n_chunks:
        e = min(c + segment_chunks, n_chunks)
        audio_seg = torch.empty((perf.num_channels, (e - c) * chunk_size),
                                dtype=torch.float32, device=dev)
        for i in range(c, e):
            state, chunk = step(state, i * chunk_size, chunk_slice(xs, i))
            audio_seg[:, (i - c) * chunk_size:(i - c + 1) * chunk_size] = chunk
        segments.append(audio_seg.cpu().numpy())
        c = e
        save_checkpoint(checkpoint_path, c, state, np.concatenate(segments, axis=1))

    audio = np.concatenate(segments, axis=1)
    return audio[:, :total_frames]
