"""Chunked offline and streaming renderer (port of zang_tpu/graph/render.py).

The JAX package renders the piece as one lax.scan over chunks; here it is a
host loop over chunks that carries the state ((per-part states, post
state): filter l/b, decimator counters, delay lines). One chunk is one call
of the step that make_stream_step returns: the chunk's program slices are
cut on the device (the tiled format, from each SegProgram's tables, which
the step sends up once) or go to it (the flat format), and every part
renders. render_performance writes the chunks
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
  capturable (class attribute, optional): render() enqueues device work
      alone (no copy from the host, no wait on the device) and takes ctx.t0
      as an int32 [1] tensor on the device as well as an int. A post_fn
      declares it as an attribute of the function. On the card, the step of
      a Performance whose parts, post chain and reduction all capture runs
      each chunk after its first two as one replay of a CUDA graph
      (make_stream_step).

A Performance may carry a reduction: reduce(buf) sums, in place, the
chunk's [1 + C, n] mix and channels over the processes that each render a
share of the voices (parallel/mesh.py: torch.distributed.all_reduce), between
render_parts and finish_chunk. Without one (one device) the chunk goes from
the parts to the post chain as it is.
"""

import functools
import threading
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import arrays_to_device, device_dtype, require_device
from ..ops.segprog import SegProgram, WindowPlan, chunkify, chunkify_tiled, plan_windows
from ..ops.tile_windows import SegTable, tile_windows
from ..trace import capture_counts, count, span
from ..tree import tree_copy_, tree_leaves, tree_map

TILE = 512


def tiled(chunk_size: int, tile: int = TILE) -> bool:
    """Whether a chunk of chunk_size frames takes the tiled format."""
    return chunk_size % tile == 0 and chunk_size >= tile


@dataclass(frozen=True)
class RenderCtx:
    sample_rate: float
    t_idx: torch.Tensor  # int32 [n] absolute frame indices of this chunk
    t0: Union[int, torch.Tensor]  # t_idx[0]; int32 [1] on the card in a graph
    n: int  # chunk length


class Performance:
    """A set of (instrument, timelines) rendered into one mix.

    post_fn, if given, maps (post state, mix [n], ctx) -> (post state,
    audio [C, n]) and owns the effect state (delays, filters);
    post_init_state(device) makes its initial state. programs, if given,
    replaces planning: the per-part program dicts
    (convert.from_jax_performance passes the JAX package's plans). reduce,
    if given, is the chunk's sum over ranks (see the module's docstring);
    a `capturable` attribute on it says it may run inside a CUDA graph."""

    def __init__(
        self,
        parts: Sequence[Tuple[object, list]],
        sample_rate: float,
        programs: Optional[List[dict]] = None,
        num_channels: int = 1,
        post_fn: Optional[Callable] = None,
        post_init_state: Optional[Callable] = None,
        reduce: Optional[Callable] = None,
    ) -> None:
        self.parts = list(parts)
        self.sample_rate = float(sample_rate)
        self.num_channels = num_channels
        self.post_fn = post_fn
        self.post_init_state = post_init_state
        self.reduce = reduce
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
        """Host: what the chunk step needs of every SegProgram. When the chunk
        is a whole number of tiles, a WindowPlan (ops/segprog.plan_windows):
        the step cuts each chunk's tiles on the device from the program's
        tables (ops/tile_windows.py). Otherwise the flat format's per-chunk
        slices ([n_chunks, ...] arrays, chunkify). Other leaves become () and
        are merged back per chunk. Returns (tree, n_chunks)."""
        n_chunks = -(-total_frames // chunk_size)

        def conv(sp: SegProgram):
            if tiled(chunk_size, tile):
                return plan_windows(sp, chunk_size, n_chunks, total_frames, tile)
            ch = chunkify(sp, chunk_size, n_chunks, total_frames)
            return {"starts": ch.starts, **ch.values}

        with span("slice"):
            return _per_program(self.programs, conv), n_chunks

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
                # the chunk's slice of each SegProgram in the program's place
                prog = tree_map(_second, static_prog, xs_chunk, leaf=SegProgram)
                st2, audio = inst.render(st, prog, ctx)
                if getattr(inst, "output_channels", None) is not None:
                    multi = multi + audio
                elif audio.dim() == 2:  # [V, n] -> sum voices
                    mix = mix + audio.sum(dim=0)
                else:
                    mix = mix + audio
                new_states.append(st2)
            return new_states, mix, multi

    def reduce_chunk(self, mix, multi):
        """The chunk's mix [n] and channels [C, n] summed over the ranks:
        one reduce() of a fresh [1 + C, n] buffer (the post state may keep
        views of the mix). The identity without a reduction."""
        if self.reduce is None:
            return mix, multi
        with span("chunk.allreduce"):
            buf = torch.cat([mix[None], multi])
            count("allreduce.calls")
            count("allreduce.bytes", buf.numel() * buf.element_size())
            self.reduce(buf)
            return buf[0], buf[1:]

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
        reduce_chunk, then finish_chunk. Returns (state', [C, n])."""
        states, post_state = state
        new_states, mix, multi = self.render_parts(states, chunk_progs, ctx, programs)
        mix, multi = self.reduce_chunk(mix, multi)
        post_state, out = self.finish_chunk(post_state, mix, multi, ctx)
        return (new_states, post_state), out


def _second(_, x):
    return x


def _per_program(programs, conv: Callable):
    """programs with each SegProgram replaced by conv(it) and every other
    leaf by ()."""
    return tree_map(lambda v: conv(v) if isinstance(v, SegProgram) else (), programs)


def host_slices(perf: Performance, total_frames: int, chunk_size: int, tile: int = TILE):
    """perf.chunk_xs with the tiled format's slices built on the host
    ([n_chunks, V, nt, S] arrays, chunkify_tiled) in place of window plans,
    for a caller that needs the arrays themselves: serve/batch.py pads their
    slot axes to buckets shared across songs."""
    if not tiled(chunk_size, tile):
        return perf.chunk_xs(total_frames, chunk_size, tile)
    n_chunks = -(-total_frames // chunk_size)
    return _per_program(perf.programs, lambda sp: chunkify_tiled(
        sp, chunk_size, n_chunks, total_frames, tile)), n_chunks


def chunk_slice(xs, i: int):
    """Chunk i's slice of a perf.chunk_xs (or host_slices) tree: each
    [n_chunks, ...] array's row i; a WindowPlan stays as it is."""
    return tree_map(lambda a: a[i], xs, leaf=np.ndarray)


def capturable(perf: Performance) -> bool:
    """Whether every part's instrument, the post chain and the reduction of
    perf declare `capturable` (see the module's docstring)."""
    return (all(getattr(inst, "capturable", False) for inst, _ in perf.parts)
            and all(f is None or getattr(f, "capturable", False)
                    for f in (perf.post_fn, perf.reduce)))


ALIGN = 16  # bytes: every array of a packed chunk starts on a multiple
ARRAYS = (np.ndarray, torch.Tensor)
CHUNK_LEAVES = ARRAYS + (WindowPlan,)  # the leaves of a chunk


class ChunkLayout:
    """One packed buffer for a chunk's inputs: the chunk's first frame
    (int32) at byte 0, then each array of its slice of perf.chunk_xs, as
    the device holds it, at the next multiple of ALIGN bytes (a WindowPlan
    takes no room: it stays in the template). pack() writes a chunk into
    host views of such a buffer; views() reads a buffer (on any device) back
    as arrays, tree() puts them in the slice's places. A chunk takes the
    layout when key_of(its leaves, CHUNK_LEAVES) equals .key."""

    def __init__(self, xs_chunk) -> None:
        self.places = []  # (byte offset, shape, device dtype) a leaf
        off = ALIGN

        def place(a):
            nonlocal off
            dtype = device_dtype(a)
            self.places.append((off, tuple(a.shape), dtype))
            size = int(np.prod(a.shape, dtype=np.int64)) * dtype.itemsize
            off += -(-size // ALIGN) * ALIGN
            return len(self.places) - 1

        self.template = tree_map(place, xs_chunk, leaf=ARRAYS)
        self.nbytes = off
        self.key = self.key_of(tree_leaves(xs_chunk, CHUNK_LEAVES))

    @staticmethod
    def key_of(leaves) -> tuple:
        return tuple(a.key if isinstance(a, WindowPlan) else (tuple(a.shape), device_dtype(a))
                     for a in leaves)

    def views(self, buf: torch.Tensor):
        """(the first frame int32 [1], [each leaf]) as views of the byte
        tensor buf."""
        return buf[:4].view(torch.int32), [
            buf[off:off + int(np.prod(shape, dtype=np.int64)) * dtype.itemsize]
            .view(dtype).view(shape) for off, shape, dtype in self.places]

    def host_views(self, buf: torch.Tensor):
        """views() of a host buffer, as numpy arrays."""
        c0, leaves = self.views(buf)
        return c0.numpy(), [v.numpy() for v in leaves]

    def pack(self, host_views, c0: int, leaves) -> list:
        """Write c0 and the chunk's arrays into host_views (of host_views());
        returns [(index, tensor)] of the leaves already on a device, which
        the caller copies into the device buffer's views itself."""
        hc0, hv = host_views
        hc0[0] = c0
        on_device = []
        leaves = [a for a in leaves if not isinstance(a, WindowPlan)]
        for i, (a, v) in enumerate(zip(leaves, hv)):
            if isinstance(a, torch.Tensor):
                if a.device.type != "cpu":
                    on_device.append((i, a))
                    continue
                a = a.numpy()
            np.copyto(v, a, casting="safe")
        return on_device

    def tree(self, leaves):
        """The chunk's slice, `leaves` (of views()) in its arrays' places."""
        return tree_map(leaves.__getitem__, self.template, leaf=int)


def make_stream_step(perf: Performance, chunk_size: int = 65536, *, device="cuda"):
    """One chunk's render of `perf` on `device` (the card unless the caller
    asks for the CPU), as a callable

        step(state, c0, xs_chunk, programs=None) -> (state', audio [C, chunk_size])

    state: ((per-part states), post state), or None for perf.init_state;
    c0: the chunk's first frame; xs_chunk: that chunk's slice of
    perf.chunk_xs: its arrays (numpy) are uploaded here, and each
    WindowPlan becomes the chunk's tiles, cut on the device from the
    program's tables (ops/tile_windows.py; the counter "slice.windows"
    counts each cut). The static programs go to the device once, when the
    step is made, and every SegProgram's tables once, at the first chunk
    that carries a WindowPlan, so one step serves any number of streams of
    the same perf. programs, if given, replaces the static programs: those,
    already on the device, of another Performance with the same
    instruments, voice counts and post chain (serve/batch.py shares one
    step among such songs); such a call takes host slices (host_slices),
    not plans.

    On the card, when every part, the post chain and the reduction are
    `capturable`, the step is a GraphStep: the same bits, each chunk after
    its first two one replay of a CUDA graph fed by one packed upload.
    Otherwise, and for a call with programs, every op is enqueued from here
    (eager). Either step's .tables() sends the tables up at once (the next
    call finds them there) and returns them."""
    dev = require_device(device)
    static = arrays_to_device(perf.programs, dev)
    base = torch.arange(chunk_size, dtype=torch.int32, device=dev)

    @functools.cache
    def tables():
        """Every SegProgram's SegTable on dev, sent up when a chunk first
        needs them (None when the chunk is not a whole number of tiles)."""
        return _upload_tables(perf.programs, dev) if tiled(chunk_size) else None

    def step(state, c0: int, xs_chunk, programs=None):
        count("chunks")
        with span("chunk"):
            if state is None:
                state = perf.init_state(dev)
            ctx = RenderCtx(perf.sample_rate, base + c0, c0, chunk_size)
            with span("chunk.upload"):
                chunk_progs = arrays_to_device(xs_chunk, dev)
                if programs is not None and tree_leaves(chunk_progs, WindowPlan):
                    raise ValueError("a step given programs takes host slices "
                                     "(host_slices), not window plans")
                chunk_progs = _windows(chunk_progs, tables, c0)
            return perf.render_chunk(state, chunk_progs, ctx,
                                     static if programs is None else programs)

    if dev.type == "cuda" and capturable(perf):
        return GraphStep(perf, chunk_size, dev, static, base, step, tables)
    step.tables = tables
    return step


def _upload_tables(programs, dev):
    """programs with every SegProgram replaced by its SegTable on dev, all
    of them sent in one packed copy (a ChunkLayout's buffer); None when
    there is no SegProgram."""
    sps = tree_leaves(programs, SegProgram)
    if not sps:
        return None
    host = [{"starts": np.clip(sp.starts, -2 ** 31, 2 ** 31 - 1).astype(np.int32),
             "values": sp.values} for sp in sps]
    lay = ChunkLayout(host)
    buf = torch.empty((lay.nbytes,), dtype=torch.uint8)
    lay.pack(lay.host_views(buf), 0, tree_leaves(host))
    count("h2d.copies")
    got = iter(lay.tree(lay.views(buf.to(dev))[1]))
    return tree_map(lambda sp: SegTable(**next(got)), programs, leaf=SegProgram)


def _windows(xs, tables, c0):
    """xs (a chunk's slice) with each WindowPlan replaced by the chunk's
    tiles, cut from the SegTable at its place in tables() (tile_windows),
    which is called only for a slice that holds a plan."""
    if not tree_leaves(xs, WindowPlan):
        return xs
    t = tables()
    if t is None:
        raise ValueError("a window plan needs a step whose chunk is a whole number of tiles")
    return tree_map(lambda plan, table: tile_windows(table, plan, c0), xs, t, leaf=WindowPlan)


class GraphStep:
    """make_stream_step's step on the card for a Performance whose parts and
    post chain capture: the eager step's bits, each chunk's host work one
    packed upload and one CUDA graph replay.

    Every call packs the chunk's first frame and its arrays (the flat
    format's slices; none in the tiled format, whose tiles the graph cuts
    from the step's tables at the first frame it reads from the buffer)
    into a pinned host buffer (two, taken in turns, each reused only once
    its last copy is done) and copies it to the device in one copy_. The
    first call of a chunk shape renders eagerly from views of that device
    buffer (it warms the kernels up, and a traced job keeps one real SVF
    call); the second captures the cut and render_chunk on views of it, its
    state in buffers of the step that the graph writes the new state back
    into, and replays; every later call replays. Each call returns copies of the audio and the state, so a
    later call never overwrites what an earlier one returned; a state other
    than the one the last call returned is copied in first. A call with
    programs takes the eager step. The step is locked a call, so threads
    may share it."""

    def __init__(self, perf, chunk_size, dev, static, base, eager,
                 tables: Callable = lambda: None) -> None:
        self.perf, self.n, self.dev = perf, chunk_size, dev
        self.static, self.base, self.eager, self.tables = static, base, eager, tables
        # the replay holds the chunk's all-reduce when perf has one
        self.reduces = getattr(perf, "reduce", None) is not None
        self.layout = None
        self.lock = threading.Lock()
        self.stream = None  # the stream of the last call

    def __call__(self, state, c0: int, xs_chunk, programs=None):
        if programs is not None:
            return self.eager(state, c0, xs_chunk, programs)
        with self.lock:
            count("chunks")
            with span("chunk"):
                cur = torch.cuda.current_stream(self.dev)
                if self.stream is not None and self.stream != cur:
                    cur.wait_stream(self.stream)
                self.stream = cur
                if state is None:
                    state = self.perf.init_state(self.dev)
                leaves = tree_leaves(xs_chunk, CHUNK_LEAVES)
                if self.layout is None or ChunkLayout.key_of(leaves) != self.layout.key:
                    self._new_layout(xs_chunk)
                with span("chunk.upload"):
                    self._upload(c0, leaves)
                if self.graph is not None:
                    return self._replay(state)
                if self.warm:
                    self._capture(state)
                    return self._replay(state)
                self.warm = True
                ctx = RenderCtx(self.perf.sample_rate, self.base + c0, c0, self.n)
                return self.perf.render_chunk(state, _windows(self.xs, self.tables, self.c0),
                                              ctx, self.static)

    def _new_layout(self, xs_chunk) -> None:
        lay = self.layout = ChunkLayout(xs_chunk)
        self.buf = torch.empty((lay.nbytes,), dtype=torch.uint8, device=self.dev)
        self.c0, self.buf_views = lay.views(self.buf)
        self.xs = lay.tree(self.buf_views)
        self.staging = [torch.empty((lay.nbytes,), dtype=torch.uint8, pin_memory=True)
                        for _ in range(2)]
        self.host = [lay.host_views(b) for b in self.staging]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]  # each one's last copy
        self.turn = 0
        self.graph = self.out = self.returned = None  # empty_cache may free the old pool
        self.warm = False

    def _upload(self, c0: int, leaves) -> None:
        k, self.turn = self.turn, self.turn ^ 1
        self.copied[k].synchronize()
        on_device = self.layout.pack(self.host[k], c0, leaves)
        self.buf.copy_(self.staging[k], non_blocking=True)
        count("h2d.copies")
        self.copied[k].record()
        for i, a in on_device:
            self.buf_views[i].copy_(a)

    def _capture(self, state) -> None:
        self.state = tree_map(torch.empty_like, state, leaf=torch.Tensor)  # _replay fills it
        # The memory pools of graphs that have died are freed by empty_cache
        # alone (an allocation that fails while a graph is captured frees no
        # cached block): free them before this graph takes room of its own.
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(self.stream)
        with torch.cuda.stream(side), capture_counts() as launches:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                ctx = RenderCtx(self.perf.sample_rate, self.base + self.c0, self.c0, self.n)
                new_state, self.out = self.perf.render_chunk(
                    self.state, _windows(self.xs, self.tables, self.c0), ctx, self.static)
                tree_copy_(self.state, new_state)
            finally:
                graph.capture_end()
        self.stream.wait_stream(side)
        self.graph, self.launches = graph, launches
        count("graph.captures")

    def _replay(self, state):
        if state is not self.returned:
            tree_copy_(self.state, state)
        with span("chunk.replay"), (span("chunk.allreduce") if self.reduces
                                    else nullcontext()):
            self.graph.replay()
        count("graph.replays")
        for name, n in self.launches.items():
            count(name, n)
        self.returned = tree_map(torch.Tensor.clone, self.state, leaf=torch.Tensor)
        return self.returned, self.out.clone()


def _chunks(perf: Performance, total_frames: int, chunk_size: int, step, state,
            sliced=None):
    """(c0, audio [C, chunk_size]) of each chunk in order, the state carried.
    sliced: perf.chunk_xs(total_frames, chunk_size) when the caller has it."""
    xs, n_chunks = sliced or perf.chunk_xs(total_frames, chunk_size)
    for i in range(n_chunks):
        c0 = i * chunk_size
        state, audio = step(state, c0, chunk_slice(xs, i))
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
    sliced=None,
) -> torch.Tensor:
    """Render the piece on `device` (the card unless the caller asks for the
    CPU); returns f32 [num_channels, total_frames] on that device. state:
    the initial ((per-part states), post state) (default
    perf.init_state(device)). sliced: perf.chunk_xs(total_frames,
    chunk_size), when the caller has already cut the programs."""
    dev = require_device(device)
    step = make_stream_step(perf, chunk_size, device=dev)
    n_chunks = -(-total_frames // chunk_size)
    out = torch.empty((perf.num_channels, n_chunks * chunk_size),
                      dtype=torch.float32, device=dev)
    for c0, audio in _chunks(perf, total_frames, chunk_size, step, state, sliced):
        out[:, c0:c0 + chunk_size] = audio
    return out[:, :total_frames]
