"""Several devices (port of zang_tpu/parallel/mesh.py).

The JAX package shards every per-voice array over a one-axis device mesh in
one process and leaves the mix's cross-device sum to GSPMD (a psum). Here a
render runs ONE PROCESS A DEVICE (torch.multiprocessing, spawn): threads on
one card queue behind one GIL (PERF.md §7), processes do not. The ranks and
their process group start once and take jobs until they are closed
(ShardedRenderer; render_performance_sharded is one job through one). Each
rank, a job,

- builds its block from the job's picklable `build(rank, world)`: the
  contiguous block [r V/W, (r+1) V/W) of every part's voices, so it plans
  and slices only those (host/configs.texture_block_build draws and
  compiles only its own voices; whole() builds the piece and cuts it,
  shard_parts);
- renders its voices a chunk at a time through make_stream_step's step
  (GraphStep on the card): Performance.render_chunk renders the parts,
  sums the chunk's [1 + C, n] mix and channels over the ranks with one
  torch.distributed.all_reduce(SUM) (the Performance's reduction: NCCL's is
  captured in the chunk's graph, gloo's runs eagerly), then
- runs the post chain (Performance.finish_chunk) on the summed mix. The
  post state is replicated: every rank holds the same one and computes the
  same bits, as the JAX package replicates it (zang_tpu/parallel/mesh.py
  :104-111). The sum goes before the post chain because the chain is not
  linear in the mix (StereoEchoes feeds back through an SVF).

The all-reduce changes the order of the voice sum, so W ranks render within
-120 dBFS of one (tests/test_parallel.py:45-47); at W = 1 it is the
identity and the render is render_performance's, bit for bit. Each rank
routes its kernels by its own voice count (ops/filters.py svf_table_route),
where the JAX package sees the global shape.

Voice counts are padded to a multiple of the rank count with silent voices
(pad_timelines): empty timelines render exact zeros and carry no state
transitions.

The live fleet needs no collective (lanes never interact): LiveFleet takes
a Mesh and renders a group of lanes a device in one process
(serve/live.py).
"""

import copy
import functools
import hashlib
import os
import queue
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import trace
from ..core import mixdown
from ..core.timeline import SubvoiceTimeline
from ..device import require_device
from ..graph.render import Performance, render_performance
from ..host.instruments import NiceInstrument

AXES = ("voices", "lanes")
BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Mesh:
    """The devices of a sharded render (a rank each) or of a lane-sharded
    fleet (a group of lanes each), the axis they split, and the
    torch.distributed backend of the ranks."""

    devices: Tuple[torch.device, ...]
    axis: str = "voices"
    backend: str = "gloo"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device="cuda", axis: str = "voices",
              backend: Optional[str] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh (zang_tpu/parallel/mesh.py make_mesh).

    device="cuda": the cards cuda:0 .. n-1 (every card when n_devices is
    None); fewer cards than asked for raises, the mesh is never shrunk.
    device="cpu": n CPU entries (one when n_devices is None), the
    counterpart of the JAX tests' virtual CPU devices. devices: an explicit
    list instead, which may repeat a device (two ranks on one card).

    backend: "nccl" when every device is a distinct card, else "gloo"
    (NCCL refuses two ranks on one card); naming "nccl" for repeated or
    CPU devices raises."""
    if axis not in AXES:
        raise ValueError(f"axis {axis!r}: one of {AXES}")
    if devices is None:
        kind = require_device(device)
        if kind.type == "cuda":
            have = torch.cuda.device_count()
            n = have if n_devices is None else n_devices
            if n > have:
                raise RuntimeError(f"a mesh of {n} cards asked for, {have} present")
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [kind] * (1 if n_devices is None else n_devices)
    else:
        devs = []
        for d in devices:
            d = require_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices given")
    if not devs:
        raise ValueError("a mesh needs at least one device")
    distinct = all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs)
    if backend is None:
        backend = "nccl" if distinct else "gloo"
    elif backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    elif backend == "nccl" and not distinct:
        raise ValueError("nccl needs a distinct card a rank; use gloo for "
                         f"{[str(d) for d in devs]}")
    return Mesh(tuple(devs), axis, backend)


def pad_timelines(
    timelines: List[SubvoiceTimeline], multiple: int
) -> List[SubvoiceTimeline]:
    """Pad a part's subvoice list with silent voices to a multiple."""
    total = timelines[0].total
    out = list(timelines)
    while len(out) % multiple:
        out.append(
            SubvoiceTimeline(
                starts=np.zeros((0,), dtype=np.int64),
                resets=np.zeros((0,), dtype=bool),
                params=[],
                total=total,
            )
        )
    return out


# the array attributes that hold a value a voice, by instrument class: the
# song's merged organ carries a [V] pulse color (host/song.py)
PER_VOICE = {NiceInstrument: ("color",)}


def _voice_slice(inst, lo: int, hi: int, voices: int):
    """`inst` for the voices [lo, hi) of a part of `voices` voices: its
    per-voice attributes cut with the voices (an attribute shorter than the
    part, whose pad voices are silent, is first padded with its last value).
    An instrument without array attributes is shared; one whose array
    attributes PER_VOICE does not name raises."""
    arrays = [k for k, v in vars(inst).items()
              if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1]
    if not arrays:
        return inst
    unknown = [k for k in arrays if k not in PER_VOICE.get(type(inst), ())]
    if unknown:
        raise ValueError(f"{type(inst).__name__} has array attributes {unknown} that "
                         "shard_parts does not know how to cut by voice")
    out = copy.copy(inst)
    for k in arrays:
        a = np.asarray(getattr(inst, k))
        if a.shape[0] > voices:
            raise ValueError(f"{type(inst).__name__}.{k} has {a.shape[0]} entries for "
                             f"{voices} voices")
        pad = np.repeat(a[-1:], voices - a.shape[0], axis=0)
        setattr(out, k, np.concatenate([a, pad])[lo:hi].copy())
    return out


def shard_parts(parts: Sequence, rank: int, world: int) -> list:
    """[(instrument, timelines)] of rank `rank` of `world`: the contiguous
    block [rank V/world, (rank+1) V/world) of every part's V voices, each
    instrument cut with them (_voice_slice). Every V must be a multiple of
    world (pad_timelines)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of {world}")
    out = []
    for i, (inst, tls) in enumerate(parts):
        V = len(tls)
        if V % world:
            raise ValueError(f"part {i} has {V} voices, not a multiple of {world} ranks: "
                             "pad its timelines with pad_timelines")
        lo, hi = rank * (V // world), (rank + 1) * (V // world)
        out.append((_voice_slice(inst, lo, hi, V), list(tls[lo:hi])))
    return out


# ---------------------------------------------------------------------------
# one process a device


@dataclass(frozen=True)
class Rank:
    """What a rank's function is told: its index, the rank count, its device
    (already current) and the process group's backend."""

    rank: int
    world: int
    device: torch.device
    backend: str


def _rank_main(fn, mesh: Mesh, rank: int, init: str, results, threads: int, args) -> None:
    try:
        torch.set_num_threads(threads)
        dev = mesh.devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(mesh.backend, init_method=init, world_size=mesh.size,
                                rank=rank)
        out = fn(Rank(rank, mesh.size, dev, mesh.backend), *args)
    except BaseException:
        # reported before the group goes down, which fails the other ranks
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def run_ranks(fn: Callable, mesh: Mesh, *args, timeout: Optional[float] = None,
              num_threads: Optional[int] = None) -> list:
    """fn(Rank, *args) in one spawned process a device of `mesh`, joined in
    one torch.distributed process group (mesh.backend; a file:// rendezvous
    in a temporary directory, so concurrent callers cannot collide).
    Returns each rank's return value, by rank.

    fn and args are pickled: fn is a module-level function. Each rank runs
    torch on num_threads threads (default: the cores shared among the
    ranks). A rank that raises makes this raise with its traceback, and a
    call past `timeout` seconds raises TimeoutError; either way every rank
    still running is ended. Build the CUDA kernels before calling: each
    rank would otherwise build them again (ops/_build.py)."""
    world = mesh.size
    threads = num_threads or max(1, (os.cpu_count() or 1) // world)
    ctx = mp.get_context("spawn")  # the caller may have started CUDA: no fork
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="zang_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, mesh, r, init, results, threads, args))
                 for r in range(world)]
        out, errors = {}, {}
        try:
            for p in procs:
                p.start()
            settle = None  # once a rank failed: until when the others' reports may come
            while len(out) + len(errors) < world:
                if settle is not None and time.monotonic() > settle:
                    break
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} "
                                           f"not done after {timeout} s") from None
                    if settle is None and any(r not in out and p.exitcode not in (None, 0)
                                              for r, p in enumerate(procs)):
                        settle = time.monotonic() + 2.0  # its traceback may be on its way
                    continue
                if ok:
                    out[rank] = value
                else:
                    errors[rank] = value
                    settle = settle or time.monotonic() + 2.0
            if len(out) < world:
                silent = [f"\nrank {r}: exit code {procs[r].exitcode}" for r in range(world)
                          if r not in out and r not in errors]
                raise RuntimeError(f"{world - len(out)} of {world} ranks failed" + "".join(
                    f"\nrank {r} raised:\n{tb}" for r, tb in sorted(errors.items()))
                    + "".join(silent))
        finally:
            for p in procs:
                if p.is_alive():
                    p.join(timeout=10 if len(out) == world else 0)
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the sharded render


@dataclass(frozen=True)
class RenderJob:
    """One piece for the ranks. build: a picklable callable (a module-level
    function or a functools.partial of one) that a rank calls as
    build(rank, world) and that returns (parts, sample_rate, perf_kwargs):
    the rank's share of every part's voices (host/configs.py
    texture_block_build builds one block; whole() wraps a build of the
    whole piece), perf_kwargs the Performance's num_channels, post_fn and
    post_init_state, made for the FULL voice count. out_path: where
    render_rank's rank 0 saves the f32 [C, total_frames] mix (np.save).
    volume: rank 0 returns the mix as s16 at this volume, mixed down on its
    device (else f32). observe: a picklable observe(rank, run) -> dict that
    calls run() (the rank's job, returning its dict) and may wrap it and add
    to what it returns (a profiler, the port's recorder)."""

    build: Callable
    total_frames: int
    chunk_size: int
    out_path: Optional[str] = None
    volume: Optional[float] = None
    observe: Optional[Callable] = None


def _whole(build: Callable, rank: int, world: int):
    parts, sample_rate, perf_kwargs = build()
    return shard_parts(parts, rank, world), sample_rate, perf_kwargs


def whole(build: Callable) -> Callable:
    """A RenderJob build from a zero-argument build of the whole piece
    (host/song.song_build, host/configs.poly_echo_build): every rank builds
    it whole and keeps its block of every part (shard_parts), so its
    timelines pad to a multiple of the rank count."""
    return functools.partial(_whole, build)


_KERNELS = ("svf_table", "svf_dense", "svf_onepass", "table_lookup", "sampler_play",
            "fm_feedback", "tile_windows")


def launch_counts() -> dict:
    """The six kernels' launch counts in this process (the counters
    "launch.<kernel>" of trace.counters()), and under "sampler_play" how
    many of table_lookup's came from its fused entry."""
    c = trace.counters()
    return {k: c.get("launch." + k, 0) for k in _KERNELS}


def reset_launch_counts() -> None:
    """Set the launch counts of launch_counts() in this process to 0."""
    trace.reset_counters("launch.")


def _all_reduce(buf: torch.Tensor) -> None:
    dist.all_reduce(buf)


def _all_reduce_nccl(buf: torch.Tensor) -> None:
    dist.all_reduce(buf)


# NCCL's collective is enqueued on the card like a kernel, so a graph
# captures it (graph/render.GraphStep); gloo's runs on the host
_all_reduce_nccl.capturable = True
REDUCE = {"nccl": _all_reduce_nccl, "gloo": _all_reduce}


def _run_job(rank: Rank, job: RenderJob) -> dict:
    """The rank's share of one job: its block built (span "shard.build"),
    planned and sliced, then rendered through make_stream_step's step (a
    GraphStep on the card) with the chunk's mix summed over the ranks
    between the parts and the post chain. Returns the rank, its device,
    its voices a part, the seconds of the build, of planning its voices, of
    slicing their programs into chunks and of the render (synchronised),
    the kernels' launches in the render, the change of every counter of
    trace.counters() over the render (chunks, uploads, graph replays,
    all-reduces), the peak device memory over the
    render (bytes and GiB, None on the CPU), the SHA-256 of its mix and its
    process id; rank 0's also holds the mix under "out"."""
    dev = rank.device
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    with trace.span("shard.build"):
        parts, sample_rate, perf_kwargs = job.build(rank.rank, rank.world)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    perf = Performance(parts, sample_rate, reduce=REDUCE[rank.backend], **perf_kwargs)
    plan_s = time.perf_counter() - t
    t = time.perf_counter()
    sliced = perf.chunk_xs(job.total_frames, job.chunk_size)
    slice_s = time.perf_counter() - t
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    before = trace.counters()
    t = time.perf_counter()
    audio = render_performance(perf, job.total_frames, job.chunk_size, device=dev,
                               sliced=sliced)
    if cuda:
        torch.cuda.synchronize(dev)
    render_s = time.perf_counter() - t
    del sliced
    mix = audio.cpu().numpy()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    out = {
        "rank": rank.rank, "world": rank.world, "device": str(dev),
        "backend": rank.backend, "voices": [len(tls) for _, tls in perf.parts],
        "build_s": build_s, "plan_s": plan_s, "slice_s": slice_s,
        "render_s": render_s, "launches": launch_counts(),
        "counts": {k: v - before.get(k, 0) for k, v in trace.counters().items()
                   if v != before.get(k, 0)},
        "peak_bytes": peak, "peak_gib": None if peak is None else peak / 2 ** 30,
        "digest": hashlib.sha256(mix.tobytes()).hexdigest(), "pid": os.getpid(),
    }
    if rank.rank == 0:
        out["out"] = (mix if job.volume is None
                      else mixdown.mixdown_s16(audio, job.volume).cpu().numpy())
    return out


def _job(rank: Rank, job: RenderJob) -> dict:
    run = functools.partial(_run_job, rank, job)
    return run() if job.observe is None else job.observe(rank, run)


def render_rank(rank: Rank, jobs: Sequence[RenderJob]) -> List[dict]:
    """One rank's share of each job, in order (run_ranks' fn: a launch of
    ranks that renders a fixed list of jobs and ends). Returns _run_job's
    dict a job; rank 0 saves each mix at the job's out_path."""
    stats = []
    for job in jobs:
        st = _job(rank, job)
        out = st.pop("out", None)
        if out is not None and job.out_path is not None:
            np.save(job.out_path, out)
        stats.append(st)
    return stats


READY = 0  # the key of the item each of a ShardedRenderer's ranks puts first


def _end_with(caller) -> None:
    """End this process as soon as `caller` (the process that started it)
    has ended, whatever its main thread is doing."""
    caller.join()
    os._exit(1)


def serve_rank(rank: Rank, jobs, results) -> None:
    """A ShardedRenderer's rank (run_ranks' fn): puts (READY, rank, None)
    on results once its process group is open, then takes (key, RenderJob)
    items from jobs[rank] and puts (key, rank, its dict) on results, one
    job after another, until it takes None. A thread ends the process when
    its caller's has ended."""
    threading.Thread(target=_end_with, args=(mp.parent_process(),), daemon=True).start()
    results.put((READY, rank.rank, None))
    inbox = jobs[rank.rank]
    while True:
        item = inbox.get()
        if item is None:
            return
        key, job = item
        results.put((key, rank.rank, _job(rank, job)))


class ShardedRenderer:
    """Ranks that persist across jobs: run_ranks(serve_rank) over the mesh
    (one process a device, their process group opened once) in a thread of
    the caller, fed one RenderJob at a time.

        with ShardedRenderer(make_mesh(4)) as r:
            out, ranks = r.render(RenderJob(build, total, chunk, volume=0.25))

    render(job) returns (rank 0's mix on the host: s16 when the job gives a
    volume, else f32 [C, total]; each rank's dict of _run_job, by rank).
    The constructor returns once every rank has opened the process group.
    Every rank ends when close() is called (or the with block ends), when
    any rank raises (render raises with that rank's traceback and the
    renderer is closed), and when the caller's process dies (a thread of
    each rank waits for it). timeout: the seconds the ranks may live, as
    run_ranks takes it (None: until closed). Build the CUDA kernels before
    the first job: each rank would otherwise build them again
    (ops/_build.py)."""

    def __init__(self, mesh: Mesh, num_threads: Optional[int] = None,
                 timeout: Optional[float] = None) -> None:
        if mesh.axis != "voices":
            raise ValueError(f"a sharded render splits voices, not {mesh.axis!r}")
        ctx = mp.get_context("spawn")
        self.mesh = mesh
        self._jobs = [ctx.Queue() for _ in range(mesh.size)]
        self._results = ctx.Queue()
        self._key = 0
        self._error = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        args=(num_threads, timeout))
        self._thread.start()
        self._collect(READY)

    def _run(self, num_threads, timeout) -> None:
        try:
            run_ranks(serve_rank, self.mesh, self._jobs, self._results, timeout=timeout,
                      num_threads=num_threads)
        except Exception as e:  # render() raises it
            self._error = e

    def _collect(self, key: int) -> list:
        """Every rank's value for `key`, by rank; raises once the ranks have
        ended without them."""
        ranks = {}
        while len(ranks) < self.mesh.size:
            try:
                k, r, value = self._results.get(timeout=0.2)
            except queue.Empty:
                if not self._thread.is_alive():
                    self._closed = True
                    what = f"job {key} was done" if key != READY else "they were ready"
                    raise RuntimeError(f"the ranks ended before {what}: "
                                       f"{self._error}") from self._error
                continue
            if k == key:
                ranks[r] = value
        return [ranks[r] for r in range(self.mesh.size)]

    def render(self, job: RenderJob):
        if self._closed:
            raise RuntimeError("the renderer is closed") from self._error
        self._key += 1
        for q in self._jobs:
            q.put((self._key, job))
        stats = self._collect(self._key)
        return stats[0].pop("out"), stats

    def close(self) -> None:
        """End every rank (after the job it is rendering) and wait for them."""
        if not self._closed and self._thread.is_alive():
            for q in self._jobs:
                q.put(None)
        self._closed = True
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def render_performance_sharded(build: Callable, total_frames: int, mesh: Mesh,
                               chunk_size: int = 65536,
                               timeout: Optional[float] = None) -> np.ndarray:
    """Render the piece that `build` (a zero-argument build of the whole
    piece, as RenderJob says; wrapped in whole()) makes with its voices
    sharded over the mesh's devices, one process a device, as one job of a
    ShardedRenderer (zang_tpu/parallel/mesh.py
    render_performance_sharded). Returns f32 numpy [C, total_frames]. A
    rank that raises makes this raise, and so does a render past `timeout`
    seconds; nothing falls back."""
    with ShardedRenderer(mesh, timeout=timeout) as r:
        return r.render(RenderJob(whole(build), total_frames, chunk_size))[0]
