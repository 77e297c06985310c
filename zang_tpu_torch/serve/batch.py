"""The batch fleet on torch: render fleets of independent songs (a port of
zang_tpu/serve/batch.py, serving tier 3).

Songs are scheduled round-robin onto devices, each device renders a song's
chunks through a step shared by every song of the same instrument graph,
and WAVs stream to disk segment by segment:

- No cross-song communication; one job = one device.
- The cache is keyed on the instrument graph (instrument set and config,
  voice counts, chunking, baked scalars), not on the song. An entry is the
  step that graph/render.make_stream_step builds, built once per (graph
  key, device, emit); a song's own program arrays go to the device once a
  song and are handed to the step, and its chunks are a host loop over the
  step. `traces` counts the builds, as the JAX package's counts its
  retraces: one per graph key and device, never one per song.
- Failures re-queue the song on another attempt (renders are stateless
  between songs); `max_attempts` bounds retries.

What differs from the JAX package: it pads the chunk axis to whole
segments so that every segment has one compiled shape, and renders the
padded chunks (their audio is trimmed, their state discarded). An eager
port needs no shape of its own a segment, so it renders only the real
chunks: a 282-chunk song at 16 chunks a segment renders 282 chunks, not
288, with the same output. The slot axis is still padded to a power of two
(_pad_slot_axes): the padding changes which kernel a table-cut SVF takes
(ops/filters.svf_table_route), as it does in the JAX package. The JAX
package's compiled-executable cache (ZANG_AOT_CACHE, graph/aotcache.py) is
not ported: there is no compile to keep.
"""

import hashlib
import math
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.mixdown import mixdown_s16
from ..core.wav import StreamingWavWriter
from ..device import require_device, to_device
from ..graph.render import ARRAYS, Performance, chunk_slice, host_slices, make_stream_step
from ..ops.segprog import SegProgram
from ..tree import tree_map

# -- program splitting: per-song arrays become the step's arguments ----------


class _ConstSlot:
    """Marker replacing an array leaf in the program skeleton."""

    __slots__ = ("i",)

    def __init__(self, i: int) -> None:
        self.i = i


def _split_programs(programs):
    """-> (skeleton, consts): array leaves pulled into a flat list of numpy
    arrays and replaced by _ConstSlot markers. SegProgram leaves stay (the
    step puts their chunk slices in their places); scalars stay (they are
    part of the graph key)."""
    consts = []

    def slot(a):
        consts.append(_numpy(a))
        return _ConstSlot(len(consts) - 1)

    return tree_map(slot, list(programs), leaf=ARRAYS), consts


def _restore_programs(skeleton, consts):
    return tree_map(lambda s: consts[s.i], skeleton, leaf=_ConstSlot)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# -- graph keys --------------------------------------------------------------


def _leaf_key(v):
    if isinstance(v, np.generic):
        return ("s", v.dtype.str, v.item())
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        return ("s", type(v).__name__, v)
    if isinstance(v, (np.ndarray, torch.Tensor)):
        # by content, a tensor as its numpy bytes: two songs' equal arrays
        # (or tensors) must key alike, or no song would share an entry
        a = _numpy(v)
        return ("a", a.shape, str(a.dtype),
                hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return ("l", tuple(_leaf_key(x) for x in v))
    if isinstance(v, dict):
        return ("d", tuple(sorted((k, _leaf_key(x)) for k, x in v.items())))
    # callables / opaque objects: identity — conservative (same object
    # shares, distinct objects rebuild); the cache pins a reference so ids
    # stay unique for its lifetime
    return ("o", id(v))


def _instrument_key(inst):
    cls = type(inst)
    # private attrs are derived caches (e.g. ScriptInstrument._ir, rebuilt
    # from `compiled` on every plan; SamplerInstrument's tables on a device)
    # — identity comes from public config
    cfg = tuple(sorted(
        (k, _leaf_key(v)) for k, v in vars(inst).items()
        if not k.startswith("_")
    ))
    return (cls.__module__, cls.__qualname__, cfg)


def _skeleton_key(p):
    # folds to a hashable key, dict entries sorted as the JAX package's
    # keys are (_leaf_key too): no tree_map
    if isinstance(p, _ConstSlot):
        return ("c",)  # the array's content is the song's, not the graph's
    if isinstance(p, SegProgram):
        return ("seg", tuple(sorted(
            (k, str(a.dtype)) for k, a in p.values.items())), p.starts.shape[0])
    if isinstance(p, dict):
        return ("d", tuple(sorted((k, _skeleton_key(v)) for k, v in p.items())))
    if isinstance(p, (list, tuple)):
        return ("l", tuple(_skeleton_key(v) for v in p))
    return _leaf_key(p)


def graph_key(perf: Performance, skeleton, chunk_size: int,
              segment_chunks: int):
    return (
        tuple((_instrument_key(inst), len(tls)) for inst, tls in perf.parts),
        tuple(_skeleton_key(s) for s in skeleton),
        _leaf_key(perf.post_fn),
        _leaf_key(perf.post_init_state),
        perf.sample_rate,
        perf.num_channels,
        chunk_size,
        segment_chunks,
    )


# -- slot padding ----------------------------------------------------------------


def _pad_bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_slot_axes(programs, xs, minimum: int = 4):
    """Edge-pad the slot axis (last) of every chunkified program dict of
    xs (host_slices(perf, ...), whose SegPrograms are `programs`) to a
    power-of-two bucket, as the JAX package does so that songs share
    compiled shapes. Edge padding is semantics-free in both formats: a
    duplicated boundary re-selects the same value (tiled) / contributes a
    zero delta (pconst). Here it also picks the kernel: poly_echo's 2-3
    slots padded to 4 stay on the one-pass SVF (K3) from 4096 voices, and 5
    slots padded to 8 go to K1 (ops/filters.svf_table_route)."""

    def pad(sp, p):
        if not isinstance(sp, SegProgram):
            return p
        S = p["tb" if "tb" in p else "starts"].shape[-1]
        B = _pad_bucket(S, minimum)
        if B == S:
            return p
        return {name: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, B - S)], mode="edge")
                for name, a in p.items()}

    return tree_map(pad, programs, xs)


# -- the shared-graph cache ---------------------------------------------------


def _device(device) -> torch.device:
    """require_device, with a bare "cuda" made the current card's index, so
    that "cuda" and "cuda:0" key one entry."""
    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SharedGraphCache:
    """Stream steps keyed on the instrument graph, not the song. `traces`
    counts the builds: one per (graph key, device, emit), so N songs on one
    device build once, and a fleet builds once per device — never once per
    song."""

    def __init__(self, max_entries: int = 64) -> None:
        self._lock = threading.Lock()
        self._fns = {}  # insertion-ordered: oldest evicted first
        # keep each entry's keyed Performance alive so its id()-based key
        # components stay unique among LIVE entries; evicting an entry and
        # its pin together means a recycled id() can only match a key that
        # no longer exists (miss -> rebuild), never a stale hit
        self._pinned = {}
        self.max_entries = max_entries
        self.traces = 0

    @staticmethod
    def _key(perf, skeleton, chunk_size, segment_chunks, emit, device):
        return graph_key(perf, skeleton, chunk_size, segment_chunks) + (
            emit, str(_device(device)))

    def has(self, perf: Performance, skeleton, chunk_size: int,
            segment_chunks: int, emit: str = "f32", device="cuda") -> bool:
        key = self._key(perf, skeleton, chunk_size, segment_chunks, emit, device)
        with self._lock:
            return key in self._fns

    def get(self, perf: Performance, skeleton, chunk_size: int,
            segment_chunks: int, emit: str = "f32", device="cuda"):
        """(step, hit): the entry's make_stream_step step on `device`."""
        key = self._key(perf, skeleton, chunk_size, segment_chunks, emit, device)
        with self._lock:
            hit = key in self._fns
            if not hit:
                while len(self._fns) >= self.max_entries:
                    oldest = next(iter(self._fns))
                    del self._fns[oldest]
                    self._pinned.pop(oldest, None)
                self._pinned[key] = perf
                self._fns[key] = make_stream_step(perf, chunk_size,
                                                  device=_device(device))
                self.traces += 1
            return self._fns[key], hit


def _fetch_async(audio: torch.Tensor):
    """(host tensor, event): audio copied to the host behind the work
    enqueued so far; on a card through pinned memory, not waited for (wait
    on the event before reading). On the CPU the tensor itself, no event."""
    if audio.device.type != "cuda":
        return audio, None
    host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
    host.copy_(audio, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def render_song_shared(
    cache: SharedGraphCache,
    perf: Performance,
    total_frames: int,
    chunk_size: int = 65536,
    segment_chunks: int = 16,
    slot_minimum: int = 4,
    on_segment: Optional[Callable[[np.ndarray], None]] = None,
    s16_volume: Optional[float] = None,
    inflight: int = 4,
    *,
    device="cuda",
) -> Optional[np.ndarray]:
    """Render one song through the shared step on `device` (the card unless
    the caller asks for the CPU), segment by segment.

    on_segment, if given, receives each trimmed [C, n] segment as it lands
    (streaming) and the function returns None; otherwise the full
    [C, total_frames] array is returned. Segments are f32 mix, or i16 PCM
    mixed down on the device when s16_volume is set. Bit-identical to
    graph.render.render_performance (+ host mixdown) at the same chunk size.

    Up to `inflight` segments are in flight before the host waits for the
    oldest: each segment's copy to the host is enqueued behind its chunks
    (into pinned memory on a card) and waited for only when it is fetched,
    so downloads overlap the next segments' work."""
    dev = _device(device)
    xs_np, n_chunks = host_slices(perf, total_frames, chunk_size)
    xs_np = _pad_slot_axes(perf.programs, xs_np, slot_minimum)
    n_seg = max(1, math.ceil(n_chunks / segment_chunks))

    emit = "s16" if s16_volume is not None else "f32"
    skeleton, consts = _split_programs(perf.programs)
    step, _ = cache.get(perf, skeleton, chunk_size, segment_chunks, emit, device=dev)
    programs = _restore_programs(skeleton, [to_device(c, dev) for c in consts])

    state = perf.init_state(dev)
    out = [] if on_segment is None else None
    pending = deque()

    def flush_one():
        host, event = pending.popleft()
        if event is not None:
            event.synchronize()
        seg = host.numpy()
        if on_segment is not None:
            if seg.shape[1]:
                on_segment(seg)
        else:
            out.append(seg)

    for s in range(n_seg):
        c_lo = s * segment_chunks
        c_hi = min(c_lo + segment_chunks, n_chunks)
        audio = torch.empty((perf.num_channels, (c_hi - c_lo) * chunk_size),
                            dtype=torch.float32, device=dev)
        for i in range(c_lo, c_hi):
            state, chunk = step(state, i * chunk_size, chunk_slice(xs_np, i), programs)
            audio[:, (i - c_lo) * chunk_size:(i - c_lo + 1) * chunk_size] = chunk
        audio = audio[:, :total_frames - c_lo * chunk_size]
        if emit == "s16":
            audio = mixdown_s16(audio, s16_volume)
        pending.append(_fetch_async(audio))
        while len(pending) >= max(1, inflight):
            flush_one()
    while pending:
        flush_one()
    if on_segment is not None:
        return None
    return np.concatenate(out, axis=1)


# -- the batch scheduler -------------------------------------------------------


@dataclass
class RenderJob:
    """One song: build() -> (Performance, total_frames). build runs on the
    worker thread (planning is part of the job)."""

    name: str
    build: Callable[[], tuple]
    volume: float = 1.0


@dataclass
class JobResult:
    name: str
    status: str  # "ok" | "failed"
    device: str = ""
    attempts: int = 0
    wav_path: Optional[str] = None
    seconds: float = 0.0
    wall_s: float = 0.0
    rtf: float = 0.0
    shared_compile: bool = False
    error: str = ""
    audio: Optional[np.ndarray] = None  # only when out_dir is None


def _no_retry(e: BaseException) -> bool:
    """Validation-class failures are deterministic: retrying a bad script
    or a malformed request body max_attempts times just burns workers.
    Retries are for transient device errors only."""
    if getattr(e, "no_retry", False):
        return True
    from ..script.errors import ScriptError

    return isinstance(e, ScriptError)


def _format_error(e: BaseException) -> str:
    """Client-facing failure text: an exception that declares public_error
    (e.g. the HTTP tier's request-validation error) supplies its own
    message; internal class names must not leak into API responses."""
    pub = getattr(e, "public_error", None)
    if pub:
        return str(pub)
    return f"{type(e).__name__}: {e}"


class BatchRenderer:
    """Round-robin scheduler: worker threads on each device, jobs from a
    shared queue, failed jobs re-queued up to max_attempts (renders are
    stateless between songs).

    devices: torch devices or their names; None means every CUDA device
    (torch.cuda.device_count()), and raises without CUDA: the CPU is used
    only when named (["cpu"], as the tests do; ["cpu", "cpu"] schedules over
    two worker groups).

    A worker renders under torch.cuda.device(dev) on that device's default
    stream, the one every thread's kernels go to unless it picks another
    (the wrappers launch on torch.cuda.current_stream). One stream a device,
    not one a worker: the steps a cache entry shares, their programs
    uploaded once, and instruments' tables cached on the device are read by
    every worker, and on one stream no read can overtake the copy that made
    them. Side streams would only overlap device work, and a render keeps
    its card busy under a quarter of the time: the host, planning and
    enqueueing under the GIL, is what the workers share, which is also why
    a device gets one worker unless the caller asks for more."""

    def __init__(
        self,
        out_dir: Optional[str] = None,
        devices: Optional[Sequence] = None,
        chunk_size: int = 65536,
        segment_chunks: int = 16,
        slot_minimum: int = 4,
        max_attempts: int = 3,
        workers_per_device: Optional[int] = None,
    ) -> None:
        self.out_dir = out_dir
        self.devices = list(devices) if devices is not None else None
        self.chunk_size = chunk_size
        self.segment_chunks = segment_chunks
        self.slot_minimum = slot_minimum
        self.max_attempts = max_attempts
        # one worker a device by default, where the JAX package runs
        # min(4, cores + 1): there a segment is one compiled call, and more
        # workers overlap one job's planning with another's device time.
        # Here the render itself is host work under the GIL (a few hundred
        # launches a chunk), and the wall of four Toccatas on one H100 grows
        # with the workers: 6.5 s at one, 12-13 at two, 25 at four, a
        # stream a worker or a shorter GIL switch interval no better
        # (tools/batch_workers.py; PERF.md §7)
        self.workers_per_device = max(1, workers_per_device or 1)
        self.cache = SharedGraphCache()

    def _resolve_devices(self) -> list:
        if self.devices is not None:
            return [_device(d) for d in self.devices]
        if not torch.cuda.is_available():
            raise RuntimeError(
                "BatchRenderer(devices=None) renders on every CUDA device, and "
                "torch.cuda.is_available() is False: pass devices=['cpu'] to "
                "render on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def run(self, jobs: Sequence[RenderJob]) -> List[JobResult]:
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"duplicate job names {dupes}: results are keyed (and WAVs "
                "written) by name — give each job a unique name")
        devices = self._resolve_devices()
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
        devices = devices[: max(1, min(len(devices), len(jobs)))]
        q: "queue.Queue" = queue.Queue()
        for job in jobs:
            q.put((job, 1))
        results = {}
        lock = threading.Lock()

        def worker(dev):
            while True:
                try:
                    job, attempt = q.get_nowait()
                except queue.Empty:
                    return
                t0 = time.time()
                try:
                    if dev.type == "cuda":
                        with torch.cuda.device(dev):
                            res = self._render_one(job, dev)
                    else:
                        res = self._render_one(job, dev)
                    res.attempts = attempt
                    res.wall_s = time.time() - t0
                    res.rtf = res.seconds / res.wall_s if res.wall_s else 0.0
                    with lock:
                        results[job.name] = res
                except Exception as e:  # noqa: BLE001 — jobs must not kill workers
                    if attempt < self.max_attempts and not _no_retry(e):
                        q.put((job, attempt + 1))
                    else:
                        with lock:
                            results[job.name] = JobResult(
                                name=job.name, status="failed",
                                device=str(dev), attempts=attempt,
                                error=_format_error(e),
                            )
                finally:
                    q.task_done()

        threads = [
            threading.Thread(target=worker, args=(d,), daemon=True)
            for d in devices
            for _ in range(self.workers_per_device)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return [
            results.get(j.name, JobResult(name=j.name, status="failed",
                                          error="not scheduled"))
            for j in jobs
        ]

    def _render_one(self, job: RenderJob, dev) -> JobResult:
        perf, total_frames = job.build()
        emit = "s16" if self.out_dir else "f32"
        hit = self.cache.has(
            perf, _split_programs(perf.programs)[0],
            self.chunk_size, self.segment_chunks, emit, device=dev,
        )
        res = JobResult(
            name=job.name, status="ok", device=str(dev),
            seconds=total_frames / perf.sample_rate, shared_compile=hit,
        )
        if self.out_dir:
            path = os.path.join(self.out_dir, f"{job.name}.wav")
            with StreamingWavWriter(
                path, int(perf.sample_rate), perf.num_channels
            ) as w:
                render_song_shared(
                    self.cache, perf, total_frames, self.chunk_size,
                    self.segment_chunks, self.slot_minimum,
                    on_segment=w.append, s16_volume=job.volume, device=dev,
                )
            res.wav_path = path
        else:
            res.audio = render_song_shared(
                self.cache, perf, total_frames, self.chunk_size,
                self.segment_chunks, self.slot_minimum, device=dev,
            )
        return res


def main(argv=None):
    """CLI: batch-render slices of the Bach song across the devices.

    python -m zang_tpu_torch.serve.batch --out DIR --songs 4 --seconds 20 [--device cuda]
    """
    import argparse
    import json

    from ..host import song as sm

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--songs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--segment-chunks", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="one device (cuda, cuda:1, cpu); default every CUDA device")
    args = ap.parse_args(argv)

    def mk(i):
        total = int(args.seconds * sm.SAMPLE_RATE)
        return lambda: (sm.build_performance(total), total)

    jobs = [
        RenderJob(name=f"toccata_{i:03d}", build=mk(i), volume=0.25)
        for i in range(args.songs)
    ]
    br = BatchRenderer(out_dir=args.out, chunk_size=args.chunk,
                       segment_chunks=args.segment_chunks,
                       devices=None if args.device is None else [args.device])
    t0 = time.time()
    results = br.run(jobs)
    wall = time.time() - t0
    total_audio = sum(r.seconds for r in results if r.status == "ok")
    print(json.dumps({
        "jobs": len(jobs),
        "ok": sum(r.status == "ok" for r in results),
        "devices": len(br._resolve_devices()),
        "traces": br.cache.traces,
        "audio_seconds": total_audio,
        "wall_s": round(wall, 2),
        "fleet_rtf": round(total_audio / wall, 1) if wall else 0.0,
    }))
    for r in results:
        print(f"  {r.name}: {r.status} dev={r.device} attempts={r.attempts} "
              f"rtf={r.rtf:.0f} shared={r.shared_compile} {r.error}")
    return 0 if all(r.status == "ok" for r in results) else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
