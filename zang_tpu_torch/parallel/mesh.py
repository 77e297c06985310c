"""Several devices (port of zang_tpu/parallel/mesh.py).

The JAX package shards every per-voice array over a one-axis device mesh in
one process and leaves the mix's cross-device sum to GSPMD (a psum). Here a
render runs ONE PROCESS A DEVICE (torch.multiprocessing, spawn): threads on
one card queue behind one GIL (PERF.md §7), processes do not. Each rank

- builds the piece from the same picklable `build` callable, keeps the
  contiguous block [r V/W, (r+1) V/W) of every part's voices (shard_parts),
  and so plans and slices only those;
- renders its voices a chunk at a time (Performance.render_parts), then
  sums the chunk's [1 + C, n] mix and channels over the ranks with one
  torch.distributed.all_reduce(SUM);
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
import hashlib
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import trace
from ..core.timeline import SubvoiceTimeline
from ..device import require_device
from ..graph.render import Performance, RenderCtx, _map_arrays, _to_device
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
    """One piece for render_rank. build: a picklable zero-argument callable
    (a module-level function or a functools.partial of one) returning
    (parts, sample_rate, perf_kwargs): the parts' timelines padded to a
    multiple of the rank count, perf_kwargs the Performance's
    num_channels, post_fn and post_init_state, made for the FULL voice
    count. out_path: where rank 0 saves the f32 [C, total_frames] mix
    (np.save)."""

    build: Callable
    total_frames: int
    chunk_size: int
    out_path: str


_KERNELS = ("svf_table", "svf_dense", "svf_onepass", "table_lookup", "sampler_play",
            "fm_feedback")


def launch_counts() -> dict:
    """The five kernels' launch counts in this process (the counters
    "launch.<kernel>" of trace.counters()), and under "sampler_play" how
    many of table_lookup's came from its fused entry."""
    c = trace.counters()
    return {k: c.get("launch." + k, 0) for k in _KERNELS}


def reset_launch_counts() -> None:
    """Set the launch counts of launch_counts() in this process to 0."""
    trace.reset_counters("launch.")


def _render_local(perf: Performance, xs, n_chunks: int, chunk_size: int,
                  dev: torch.device) -> torch.Tensor:
    """The chunk loop of render_performance with the ranks' mixes summed
    between render_parts and finish_chunk. Returns [C, n_chunks * chunk]."""
    static = [_map_arrays(p, lambda a: _to_device(a, dev)) for p in perf.programs]
    base = torch.arange(chunk_size, dtype=torch.int32, device=dev)
    states, post = perf.init_state(dev)
    out = torch.empty((perf.num_channels, n_chunks * chunk_size), dtype=torch.float32,
                      device=dev)
    for i in range(n_chunks):
        c0 = i * chunk_size
        ctx = RenderCtx(perf.sample_rate, base + c0, c0, chunk_size)
        chunk_progs = _map_arrays(xs, lambda a: _to_device(a[i], dev))
        states, mix, multi = perf.render_parts(states, chunk_progs, ctx, static)
        # a fresh buffer a chunk: the post state may keep views of the mix
        buf = torch.cat([mix[None], multi])
        dist.all_reduce(buf)
        post, audio = perf.finish_chunk(post, buf[0], buf[1:], ctx)
        out[:, c0:c0 + chunk_size] = audio
    return out


def render_rank(rank: Rank, jobs: Sequence[RenderJob]) -> List[dict]:
    """One rank's share of each job, in order (run_ranks' fn for
    render_performance_sharded). Returns a dict a job: the rank, its
    device, its voices a part, the seconds of building the timelines, of
    planning its voices, of slicing their programs into chunks and of the
    render (synchronised), the kernels' launches in the render, the peak
    device memory (GiB, None on the CPU) and the SHA-256 of its mix."""
    dev = rank.device
    cuda = dev.type == "cuda"
    stats = []
    for job in jobs:
        t = time.perf_counter()
        parts, sample_rate, perf_kwargs = job.build()
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        perf = Performance(shard_parts(parts, rank.rank, rank.world), sample_rate,
                           **perf_kwargs)
        plan_s = time.perf_counter() - t
        t = time.perf_counter()
        xs, n_chunks = perf.chunk_xs(job.total_frames, job.chunk_size)
        slice_s = time.perf_counter() - t
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t = time.perf_counter()
        audio = _render_local(perf, xs, n_chunks, job.chunk_size, dev)
        if cuda:
            torch.cuda.synchronize(dev)
        render_s = time.perf_counter() - t
        launches = launch_counts()
        mix = audio[:, :job.total_frames].cpu().numpy()
        del audio, xs
        if rank.rank == 0:
            np.save(job.out_path, mix)
        stats.append({
            "rank": rank.rank, "world": rank.world, "device": str(dev),
            "backend": rank.backend, "voices": [len(tls) for _, tls in perf.parts],
            "build_s": build_s, "plan_s": plan_s, "slice_s": slice_s,
            "render_s": render_s, "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None,
            "digest": hashlib.sha256(mix.tobytes()).hexdigest(),
        })
    return stats


def render_performance_sharded(build: Callable, total_frames: int, mesh: Mesh,
                               chunk_size: int = 65536,
                               timeout: Optional[float] = None) -> np.ndarray:
    """Render the piece that `build` makes with its voices sharded over the
    mesh's devices, one process a device (zang_tpu/parallel/mesh.py
    render_performance_sharded; RenderJob says what `build` returns).
    Returns f32 numpy [C, total_frames]. A rank that raises makes this
    raise; nothing falls back."""
    if mesh.axis != "voices":
        raise ValueError(f"a sharded render splits voices, not {mesh.axis!r}")
    with tempfile.TemporaryDirectory(prefix="zang_sharded_") as tmp:
        path = os.path.join(tmp, "mix.npy")
        run_ranks(render_rank, mesh, [RenderJob(build, total_frames, chunk_size, path)],
                  timeout=timeout)
        return np.load(path)
