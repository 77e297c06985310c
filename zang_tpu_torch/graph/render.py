"""Chunked offline and streaming renderer (port of zang_tpu/graph/render.py).

The JAX package renders the piece as one lax.scan over chunks; here it is a
host loop over chunks that carries the state ((per-part states, post
state): filter l/b, decimator counters, delay lines). One chunk is one call
of the step that make_stream_step returns: the chunk's program slices go
to the device and every part renders. render_performance writes the chunks
into one preallocated device tensor [C, n_chunks * chunk]; stream_blocks
yields them one at a time as f32 numpy blocks, the same bits.

An Instrument provides:
  plan(timelines, sample_rate) -> program dict (host, numpy); SegProgram
      leaves get sliced per chunk, other numpy leaves go to the device once
  init_state(num_voices, device) -> state (dict of tensors, or ())
  render(state, prog, ctx) -> (state', audio)
      prog has SegProgram leaves replaced by chunk slices on the device
      (ops/segprog.py): tiled {"tb": [V, nt, S], name: [V, nt, S]} when the
      chunk is a whole number of 512-frame tiles, else flat
      {"starts": [V, Kc], name: [V, Kc]}. audio is [V, n] (voices summed
      into the mono mix), or [C, n] pre-mixed when the instrument has
      `output_channels`.
"""

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import require_device
from ..ops.segprog import SegProgram, chunkify, chunkify_tiled
from ..trace import count, span

TILE = 512


@dataclass(frozen=True)
class RenderCtx:
    sample_rate: float
    t_idx: torch.Tensor  # int32 [n] absolute frame indices of this chunk
    t0: int  # t_idx[0]
    n: int  # chunk length


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:  # u32 rides int64 (ops/scan.py)
        a = a.astype(np.int64)
    count("h2d.copies")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class Performance:
    """A set of (instrument, timelines) rendered into one mix.

    post_fn, if given, maps (post state, mix [n], ctx) -> (post state,
    audio [C, n]) and owns the effect state (delays, filters);
    post_init_state(device) makes its initial state. programs, if given,
    replaces planning: the per-part program dicts
    (convert.from_jax_performance passes the JAX package's plans)."""

    def __init__(
        self,
        parts: Sequence[Tuple[object, list]],
        sample_rate: float,
        programs: Optional[List[dict]] = None,
        num_channels: int = 1,
        post_fn: Optional[Callable] = None,
        post_init_state: Optional[Callable] = None,
    ) -> None:
        self.parts = list(parts)
        self.sample_rate = float(sample_rate)
        self.num_channels = num_channels
        self.post_fn = post_fn
        self.post_init_state = post_init_state
        if programs is None:
            with span("plan.programs"):
                programs = [inst.plan(tls, self.sample_rate) for inst, tls in self.parts]
        self.programs = programs

    def init_state(self, device):
        """((per-part states), post state) on `device`."""
        states = [inst.init_state(len(tls), device) for inst, tls in self.parts]
        post = self.post_init_state(device) if self.post_init_state else ()
        return states, post

    def chunk_xs(self, total_frames: int, chunk_size: int, tile: int = TILE):
        """Host: per-chunk slices of every SegProgram ([n_chunks, ...]
        arrays), tiled when the chunk is a whole number of tiles, flat
        otherwise; other leaves become () and are merged back per chunk."""
        n_chunks = -(-total_frames // chunk_size)

        def conv(sp: SegProgram):
            if chunk_size % tile == 0 and chunk_size >= tile:
                return chunkify_tiled(sp, chunk_size, n_chunks, total_frames, tile)
            ch = chunkify(sp, chunk_size, n_chunks, total_frames)
            return {"starts": ch.starts, **ch.values}

        def walk(prog):
            if isinstance(prog, SegProgram):
                return conv(prog)
            if isinstance(prog, dict):
                return {k: walk(v) for k, v in prog.items()}
            if isinstance(prog, (list, tuple)):
                return type(prog)(walk(v) for v in prog)
            return ()

        with span("slice"):
            return [walk(p) for p in self.programs], n_chunks

    def merge_chunk(self, prog, xs_chunk):
        """Merge chunk-local seg slices into the static program structure."""
        if isinstance(prog, SegProgram):
            return xs_chunk
        if isinstance(prog, dict):
            return {k: self.merge_chunk(v, xs_chunk[k]) for k, v in prog.items()}
        if isinstance(prog, (list, tuple)):
            return type(prog)(self.merge_chunk(v, x) for v, x in zip(prog, xs_chunk))
        return prog

    def render_parts(self, states, chunk_progs, ctx: RenderCtx, programs=None):
        """Every part's share of one chunk (zang_tpu/graph/render.py
        render_chunk, the loop over parts): each part renders [V, n], summed
        over its voices into the mono mix, or [C, n] when it has
        `output_channels`. programs: the static programs with numpy leaves
        already on the device. Returns (states', mix [n], multi [C, n]).
        Both sums are linear in the voices, so ranks that each hold a slice
        of every part's voices add theirs up before finish_chunk
        (parallel/mesh.py)."""
        with span("chunk.parts"):
            dev = ctx.t_idx.device
            mix = torch.zeros((ctx.n,), dtype=torch.float32, device=dev)
            multi = torch.zeros((self.num_channels, ctx.n), dtype=torch.float32, device=dev)
            new_states = []
            for (inst, _), static_prog, xs_chunk, st in zip(
                self.parts, programs if programs is not None else self.programs,
                chunk_progs, states
            ):
                st2, audio = inst.render(st, self.merge_chunk(static_prog, xs_chunk), ctx)
                if getattr(inst, "output_channels", None) is not None:
                    multi = multi + audio
                elif audio.dim() == 2:  # [V, n] -> sum voices
                    mix = mix + audio.sum(dim=0)
                else:
                    mix = mix + audio
                new_states.append(st2)
            return new_states, mix, multi

    def finish_chunk(self, post_state, mix, multi, ctx: RenderCtx):
        """The rest of the chunk: post_fn on the mix (not linear in it: the
        echoes feed back through a filter), or the mix on every channel.
        Returns (post_state', [C, n])."""
        with span("chunk.post"):
            if self.post_fn is not None:
                post_state, out = self.post_fn(post_state, mix, ctx)
                return post_state, out + multi if out.shape == multi.shape else out
            return post_state, multi + mix[None, :]  # mono goes to every channel (centre)

    def render_chunk(self, state, chunk_progs, ctx: RenderCtx, programs=None):
        """One chunk (zang_tpu/graph/render.py render_chunk): render_parts,
        then finish_chunk. Returns (state', [C, n])."""
        states, post_state = state
        new_states, mix, multi = self.render_parts(states, chunk_progs, ctx, programs)
        post_state, out = self.finish_chunk(post_state, mix, multi, ctx)
        return (new_states, post_state), out


def _map_arrays(tree, fn):
    if isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(v, fn) for v in tree)
    return tree


def make_stream_step(perf: Performance, chunk_size: int = 65536, *, device="cuda"):
    """One chunk's render of `perf` on `device` (the card unless the caller
    asks for the CPU), as a plain function

        step(state, c0, xs_chunk, programs=None) -> (state', audio [C, chunk_size])

    state: ((per-part states), post state), or None for perf.init_state;
    c0: the chunk's first frame; xs_chunk: that chunk's slice of
    perf.chunk_xs (numpy), uploaded here. The static programs go to the
    device once, when the step is made, so one step serves any number of
    streams of the same perf. programs, if given, replaces them: the static
    programs, already on the device, of another Performance with the same
    instruments, voice counts and post chain (serve/batch.py shares one step
    among such songs)."""
    dev = require_device(device)
    static = [_map_arrays(p, lambda a: _to_device(a, dev)) for p in perf.programs]
    base = torch.arange(chunk_size, dtype=torch.int32, device=dev)

    def step(state, c0: int, xs_chunk, programs=None):
        count("chunks")
        with span("chunk"):
            if state is None:
                state = perf.init_state(dev)
            ctx = RenderCtx(perf.sample_rate, base + c0, c0, chunk_size)
            with span("chunk.upload"):
                chunk_progs = _map_arrays(xs_chunk, lambda a: _to_device(a, dev))
            return perf.render_chunk(state, chunk_progs, ctx,
                                     static if programs is None else programs)

    return step


def _chunks(perf: Performance, total_frames: int, chunk_size: int, step, state):
    """(c0, audio [C, chunk_size]) of each chunk in order, the state carried."""
    xs, n_chunks = perf.chunk_xs(total_frames, chunk_size)
    for i in range(n_chunks):
        c0 = i * chunk_size
        state, audio = step(state, c0, _map_arrays(xs, lambda a, i=i: a[i]))
        yield c0, audio


def stream_blocks(perf: Performance, total_frames: int, step, chunk_size: int = 65536):
    """Drive a make_stream_step step over the piece, yielding f32 numpy
    blocks [C, <= chunk_size] in order (the state carried across chunks).
    `step` must have been made from the same perf and chunk_size."""
    for c0, audio in _chunks(perf, total_frames, chunk_size, step, None):
        yield audio[:, :min(chunk_size, total_frames - c0)].cpu().numpy()


def stream_performance(perf: Performance, total_frames: int, chunk_size: int = 65536, *,
                       device="cuda"):
    """Incremental render on `device`: an iterator of f32 numpy blocks
    [C, <= chunk_size] in order, each yielded as soon as it is rendered.
    Concatenated they are render_performance's output, bit for bit. The
    device is checked here, before the first block is asked for."""
    step = make_stream_step(perf, chunk_size, device=device)
    return stream_blocks(perf, total_frames, step, chunk_size)


def render_performance(
    perf: Performance,
    total_frames: int,
    chunk_size: int = 65536,
    *,
    device="cuda",
    state=None,
) -> torch.Tensor:
    """Render the piece on `device` (the card unless the caller asks for the
    CPU); returns f32 [num_channels, total_frames] on that device. state:
    the initial ((per-part states), post state) (default
    perf.init_state(device))."""
    dev = require_device(device)
    step = make_stream_step(perf, chunk_size, device=dev)
    n_chunks = -(-total_frames // chunk_size)
    out = torch.empty((perf.num_channels, n_chunks * chunk_size),
                      dtype=torch.float32, device=dev)
    for c0, audio in _chunks(perf, total_frames, chunk_size, step, state):
        out[:, c0:c0 + chunk_size] = audio
    return out[:, :total_frames]
