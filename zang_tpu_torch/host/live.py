"""Live (interactive) host on torch (port of zang_tpu/host/live.py): the
analog of the reference's SDL audio-callback loop.

The reference host (examples/example.zig:35-83,423-440) runs a real-time
loop: the main thread pushes key events into an ImpulseQueue under a lock;
the audio callback drains the queue, splits the block at impulse frames
with a Trigger, and paints 1024-sample blocks. Here the same event
machinery runs block by block on the host, and one plain torch step
renders each block from the carried device state:

  push_event/key_event -> ImpulseQueue            (core/notes.py)
  render_block():
    queue -> PolyphonyDispatcher -> Trigger       (exact reference routing)
    new note segments extend per-voice timelines
    the incremental live planners (host/liveplan.py) give the block's
    program window {starts [V, KP] i32, name [V, KP]}, KP = slot_capacity
    (or instrument.plan over the timelines so far, sliced to the window)
    every window leaf and the block's first frame packed into one pinned
    host buffer, one host-to-card copy -> render_lanes(...) -> audio block

Events pushed with impulse_frame=0 take effect at the next block start, as
in the reference host, whose getImpulseFrame() always returns 0
(examples/example.zig:576-583). Latency is one block.

The device step (render_lanes) is shared with serve/live.py's LiveFleet,
which runs it over many sessions' lanes at once; a session is its one-lane
case. The step never holds the session lock: the lock covers event pushes
and the queue drain only, never a sync with the card.
"""

import contextlib
import copy
import os
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.mixdown import mixdown_s16
from ..core.notes import IdGenerator, ImpulseQueue, PolyphonyDispatcher
from ..core.span import Span
from ..core.timeline import SubvoiceTimeline
from ..core.trigger import Trigger
from ..device import require_device
from ..graph.render import RenderCtx, _map_arrays, _to_device
from ..ops.scan import U32
from ..ops.segprog import SegProgram
from ..trace import count, span
from . import keyboard, liveplan

PARAMS = "__params__"  # a part window's live-parameter vector [P]


def live_device(device) -> torch.device:
    """The session's device with its index fixed: a render thread must not
    depend on the current device of whichever thread calls it."""
    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts, lists and tuples (and the
    matching leaves of `rest`, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _paths(tree, path=()):
    """(path, leaf) of every leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, fn, path=()):
    """tree with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else x, tree)


def to_device(tree, device):
    """numpy leaves -> tensors on device (u32 rides int64, ops/scan.py)."""
    return _map_arrays(tree, lambda a: _to_device(a, device))


# ---------------------------------------------------------------------------
# the block's inputs: one packed upload


class BlockPack:
    """Every lane's block inputs in one [L, 1 + words] int32 buffer: a lane's
    first frame, then each numpy leaf of its part windows as raw 4-byte
    words. The host fills a pinned buffer (two, used in turns, each reused
    only after its copy has finished) and one copy takes it to the card,
    where each leaf is a view of the copy (f32 bits viewed as f32, u32
    widened to int64). Leaves that are not arrays (a scalar cutoff) stay
    on the host, from lane 0. The layout is that of the windows' shapes; a
    window of other shapes (slot capacity grown) needs a new BlockPack."""

    def __init__(self, window, device: torch.device, lanes: int) -> None:
        self.device = device
        self.lanes = lanes
        self.entries = []  # (path, shape, dtype, offset, size)
        off = 1
        for path, leaf in _paths(window):
            if isinstance(leaf, np.ndarray):
                if leaf.dtype.itemsize != 4:
                    raise ValueError(f"window leaf {path} has dtype {leaf.dtype}; "
                                     "the block pack takes 4-byte types")
                size = int(leaf.size)
                self.entries.append((path, leaf.shape, leaf.dtype, off, size))
                off += size
        pin = device.type == "cuda"
        self._bufs = [torch.empty((lanes, off), dtype=torch.int32, pin_memory=pin)
                      for _ in range(2 if pin else 1)]
        self._events = [None] * len(self._bufs)
        self._turn = 0

    def key(self):
        return tuple((p, s, d.str) for p, s, d, _, _ in self.entries)

    @staticmethod
    def layout_key(window):
        return tuple((p, leaf.shape, leaf.dtype.str) for p, leaf in _paths(window)
                     if isinstance(leaf, np.ndarray))

    def fits(self, windows, device: torch.device, lanes: int) -> bool:
        """Whether this pack takes these windows, `lanes` of them, to `device`
        (not after a slot-capacity growth changed their shapes)."""
        return (self.key() == self.layout_key(windows[0]) and self.lanes == lanes
                and self.device == device)

    def upload(self, f0s: Sequence[int], windows: Sequence) -> dict:
        """Pack and copy; returns {path: [L, ...] tensor on the card} and the
        lanes' first frames as "f0" [L] int32."""
        i = self._turn
        self._turn = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()  # its last copy has left
        buf = self._bufs[i]
        host = buf.numpy()
        host[:, 0] = np.asarray(f0s, dtype=np.int64).astype(np.int32)
        for lane, window in enumerate(windows):
            leaves = dict((p, leaf) for p, leaf in _paths(window)
                          if isinstance(leaf, np.ndarray))
            for path, shape, dtype, off, size in self.entries:
                a = leaves[path]
                if a.shape != shape or a.dtype != dtype:
                    raise ValueError(f"lane {lane}: window leaf {path} is {a.dtype} "
                                     f"{a.shape}, the pack's layout {dtype} {shape}")
                host[lane, off:off + size] = np.ascontiguousarray(a).reshape(-1).view(
                    np.int32)
        count("h2d.copies")
        if self.device.type == "cuda":
            dev = buf.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[i] = ev
        else:
            dev = buf.clone()
        out = {"f0": dev[:, 0]}
        for path, shape, dtype, off, size in self.entries:
            seg = dev[:, off:off + size].reshape((self.lanes,) + tuple(shape))
            if dtype == np.float32:
                seg = seg.view(torch.float32)
            elif dtype == np.uint32:
                seg = seg.to(torch.int64) & U32
            out[path] = seg
        return out


def _fold(v: torch.Tensor, lanes: int, voices: int, params: bool) -> torch.Tensor:
    """A window leaf [L, ...] of a part of `voices` voices as the leaf of one
    [L * voices]-voice pass: rows of `voices` (or 1, a controller's, spread
    over the lane's voices) stacked lane after lane; the parameter vector
    [L, P] becomes a row a voice [L * voices, P]."""
    if params:
        rows = v[:, None, :].expand(lanes, voices, v.shape[-1])
        return rows[0] if lanes == 1 else rows.reshape(lanes * voices, -1)
    if lanes == 1:
        return v[0]
    if v.dim() == 1:  # a value a lane
        return v.repeat_interleave(voices)
    rest = tuple(v.shape[2:])
    if v.shape[1] == voices:
        return v.reshape((lanes * voices,) + rest)
    if v.shape[1] == 1:
        return v.expand((lanes, voices) + rest).reshape((lanes * voices,) + rest)
    raise ValueError(f"window leaf of {v.shape[1]} rows in a part of {voices} voices")


def _lane_leaf(v: torch.Tensor, lane: int, voices: int, params: bool) -> torch.Tensor:
    """Lane `lane`'s own window leaf (the parameter vector as a row a voice)."""
    if params:
        return v[lane][None, :].expand(voices, v.shape[-1])
    return v[lane]


def folds(instrument, lanes: int) -> bool:
    """Whether a part renders all its lanes as one pass: an instrument that
    takes a t_idx of rows (lane_foldable) and mixes to mono. Others render a
    lane at a time (a script part: its noise keys and delay loop take host
    scalars a lane)."""
    return lanes == 1 or (getattr(instrument, "lane_foldable", False)
                          and getattr(instrument, "output_channels", None) is None)


def card_context(device: torch.device):
    """Make `device` current for the calling thread (the kernels launch on
    its current stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def render_lanes(instruments, polyphonies, states, post_states, dev, f0s, template, *,
                 sample_rate, block_size, num_channels, post_fn, device,
                 pcm16_volume=None):
    """One block of L lanes of one parts spec, on the card.

    states: a part's state, folded over lanes ([L * V] leaves) where folds()
    holds, else a list of L lane states; post_states: L post states. dev:
    BlockPack.upload's tensors; f0s: the lanes' first frames (host ints);
    template: lane 0's part windows (their structure, and the leaves that
    are not arrays). Returns (states', post_states', out [L, C, n]: f32, or
    i16 PCM when pcm16_volume is set)."""
    L, n = len(f0s), block_size
    base = torch.arange(n, dtype=torch.int32, device=device)

    def lane_ctx(lane):
        return RenderCtx(sample_rate, base + int(f0s[lane]), int(f0s[lane]), n)

    def part_tree(p, leaf_fn):
        def leaf(path, v):
            full = (p,) + path
            return leaf_fn(full, dev[full]) if full in dev else v
        return _rebuild(template[p], leaf)

    mix = torch.zeros((L, n), dtype=torch.float32, device=device)
    multi = torch.zeros((L, num_channels, n), dtype=torch.float32, device=device)
    new_states = []

    def is_params(path):
        return len(path) == 2 and path[1] == PARAMS

    for p, (inst, V, st) in enumerate(zip(instruments, polyphonies, states)):
        if folds(inst, L):
            prog = part_tree(p, lambda path, v: _fold(v, L, V, is_params(path)))
            if L == 1:
                ctx = lane_ctx(0)
            else:  # a row of frames a voice, each lane at its own clock
                t = dev["f0"].repeat_interleave(V)[:, None] + base[None, :]
                ctx = RenderCtx(sample_rate, t, None, n)
            st2, audio = inst.render(st, prog, ctx)
            if getattr(inst, "output_channels", None) is not None:
                multi = multi + audio[None]
            elif audio.dim() == 2:
                mix = mix + (audio.sum(dim=0)[None] if L == 1
                             else audio.view(L, V, n).sum(dim=1))
            else:
                mix = mix + audio.reshape(L, n)
            new_states.append(st2)
            continue
        lane_states = []
        for lane in range(L):
            prog = part_tree(p, lambda path, v: _lane_leaf(v, lane, V, is_params(path)))
            st2, audio = inst.render(st[lane], prog, lane_ctx(lane))
            if getattr(inst, "output_channels", None) is not None:
                multi[lane] = multi[lane] + audio
            elif audio.dim() == 2:
                mix[lane] = mix[lane] + audio.sum(dim=0)
            else:
                mix[lane] = mix[lane] + audio
            lane_states.append(st2)
        new_states.append(lane_states)
    if post_fn is not None:  # the effect chain a lane
        outs, new_posts = [], []
        for lane in range(L):
            ps, o = post_fn(post_states[lane], mix[lane], lane_ctx(lane))
            outs.append(o + multi[lane] if o.shape == multi[lane].shape else o)
            new_posts.append(ps)
        out = torch.stack(outs)
    else:  # mono contributions go to every channel (centre)
        out, new_posts = multi + mix[:, None, :], list(post_states)
    if pcm16_volume is not None:
        out = mixdown_s16(out, pcm16_volume)
    return new_states, new_posts, out


def push_tracked(push, tracker, sample_rate: float, block_size: int) -> int:
    """Push the next block's events of a NoteTracker (core/notes.py, the
    offline compiler's f32 frame quantization) through push(params,
    note_id=, impulse_frame=). Returns how many."""
    iap = tracker.consume(sample_rate, Span(0, block_size))
    for imp, params in zip(iap.impulses, iap.paramses):
        push(params, note_id=imp.note_id, impulse_frame=imp.frame)
    return len(iap.impulses)


# ---------------------------------------------------------------------------
# the session


@dataclass
class _PartState:
    instrument: object
    polyphony: int
    queue: ImpulseQueue
    dispatcher: PolyphonyDispatcher
    triggers: List[Trigger]
    segs: List[List[tuple]]  # per voice: (abs_start, reset, params)
    dev_state: object
    plan_cache: Optional[tuple] = None  # (key, plan)
    planner: Optional[object] = None  # incremental live planner (liveplan.py)
    params: Optional[object] = None  # ParamStore (host/params.py)
    param_vec: Optional[np.ndarray] = None  # f32 [P] device-kind values
    plan_nonce: int = 0  # bumped on plan-kind changes (re-plan cache key)
    controllers: Optional[dict] = None  # {name: [(frame, value)]} streams


class LiveSession:
    """Block-by-block interactive renderer over device instruments, on
    `device` (the card unless the caller asks for the CPU).

    parts: [(instrument, polyphony)]: instruments follow the offline
    protocol (plan / init_state / render), so the same instruments serve
    offline renders and live sessions. post_init_state(device) makes the
    post_fn's state, as in graph/render.Performance.
    """

    def __init__(
        self,
        parts: Sequence[Tuple[object, int]],
        sample_rate: float,
        block_size: int = 1024,
        num_channels: int = 1,
        post_fn: Optional[Callable] = None,
        post_init_state: Optional[Callable] = None,
        slot_capacity: int = 8,
        max_slot_capacity: int = 1024,
        device="cuda",
    ) -> None:
        self.device = live_device(device)
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.num_channels = num_channels
        self.post_fn = post_fn
        self.post_state = post_init_state(self.device) if post_init_state else ()
        self.frame = 0  # absolute session frame of the next block
        self.idgen = IdGenerator()
        # the reference host locks the audio device around every main-thread
        # mutation of shared state (examples/example.zig:425,448); here one
        # lock serializes event pushes against the block's queue drain
        self._lock = threading.Lock()
        self.slot_capacity = slot_capacity
        self.max_slot_capacity = max(slot_capacity, max_slot_capacity)
        self._pack: Optional[BlockPack] = None
        self.parts = [
            _PartState(
                instrument=inst,
                polyphony=poly,
                queue=ImpulseQueue(),
                dispatcher=PolyphonyDispatcher(poly),
                triggers=[Trigger() for _ in range(poly)],
                segs=[[] for _ in range(poly)],
                dev_state=None,  # created after the first window: some
                # instruments (ScriptInstrument) size state from the plan
                # incremental planner: O(events) host cost a block instead
                # of a full-session re-plan (ZANG_LIVE_INC=0 forces the
                # re-plan path, which the equivalence tests use)
                planner=(
                    inst.live_planner(poly, float(sample_rate))
                    if hasattr(inst, "live_planner")
                    and os.environ.get("ZANG_LIVE_INC", "1") != "0"
                    else None
                ),
            )
            for inst, poly in parts
        ]
        for part in self.parts:
            self._init_params(part)
            self._init_controllers(part)
        self._horizon = 1 << 20  # plan horizon (frames); grows by doubling
        self._held_keys = {}  # part -> {key: note_id} (default key pairing)
        # construction-time spec identity for snapshot/restore matching
        # (live parameter edits mutate instrument cfg; the values travel in
        # the snapshot)
        self._pristine_spec = self._spec_fingerprint()

    @staticmethod
    def _init_params(part: _PartState) -> None:
        """The part's live-parameter store (host/params.py) when its
        instrument declares ParamSpecs (the reference host's Parameter
        panel, example.zig:324-392)."""
        from .params import ParamStore

        inst = part.instrument
        if not hasattr(inst, "param_specs"):
            return
        specs = inst.param_specs()
        if not specs:
            return
        part.params = ParamStore(specs)
        if any(s.kind in ("device", "both") for s in specs):
            part.param_vec = np.asarray(
                inst.device_params(part.params.values), np.float32)

    @staticmethod
    def _init_controllers(part: _PartState) -> None:
        """Continuous-controller streams for instruments that declare them
        (controller_specs() -> {name: default}; the reference's mouseEvent
        path, examples/example_mouse.zig): one event at frame 0 each."""
        inst = part.instrument
        if not hasattr(inst, "controller_specs"):
            return
        specs = dict(inst.controller_specs())
        if not specs:
            return
        part.controllers = {name: [(0, float(v))] for name, v in specs.items()}
        if part.planner is not None:
            for name, v in specs.items():
                part.planner.extend_controller(name, 0, float(v))

    # -- event input ------------------------------------------------------

    def push_event(self, part: int, params: dict, note_id: Optional[int] = None,
                   impulse_frame: int = 0) -> int:
        """Push a note event for the next block (reference keyEvent path).
        Returns the note id used."""
        with self._lock:
            nid = self.idgen.next() if note_id is None else note_id
            self.parts[part].queue.push(impulse_frame, nid, params)
        return nid

    def key_event(self, part: int, key: str, down: bool, a4: float = 440.0,
                  extra: Optional[dict] = None,
                  note_ids: Optional[dict] = None) -> Optional[int]:
        """Keyboard-map helper (examples/common.zig:24-66 two-row map).

        note_ids, if given, tracks held keys so note-offs reuse the note id
        of the matching note-on (example_play.zig:84-103). When omitted,
        the session keeps its own per-part tracker: a polyphonic part's
        dispatcher drops a note-off whose id matches no held note
        (notes.zig:246-258), so an unpaired key-up would leave it stuck."""
        rel = keyboard.get_key_rel_freq(key)
        if rel is None:
            return None
        if note_ids is None:
            note_ids = self._held_keys.setdefault(part, {})
        params = {"freq": float(np.float32(a4 * rel)), "note_on": down}
        if extra:
            params.update(extra)
        nid = None
        if down:
            # re-press of a held key (auto-repeat, missed key-up): release
            # the old note first or its slot would stay note_on for ever
            old = note_ids.pop(key, None)
            if old is not None:
                self.push_event(part, {**params, "note_on": False}, note_id=old)
        else:
            nid = note_ids.pop(key, None)
            if nid is None:
                return None
        nid = self.push_event(part, params, note_id=nid)
        if down:
            note_ids[key] = nid
        return nid

    def push_controller(self, part: int, name: str, value: float,
                        frame: Optional[int] = None) -> None:
        """One continuous-controller move (the reference host's mouseEvent,
        examples/example_mouse.zig): re-targets every plan channel bound to
        `name` on the next block. Explicit frames are clamped monotonic (at
        or after the session clock and the previous move), so the
        incremental and the re-plan paths agree bit for bit."""
        p = self.parts[part]
        if p.controllers is None or name not in p.controllers:
            have = [] if p.controllers is None else sorted(p.controllers)
            raise ValueError(
                f"part {part} has no controller {name!r}; available: {have}")
        with self._lock:
            f = self.frame if frame is None else int(frame)
            f = max(f, self.frame)
            moves = p.controllers[name]
            if moves:
                f = max(f, moves[-1][0])
            p.controllers[name].append((f, float(value)))
            if p.planner is not None:
                p.planner.extend_controller(name, f, float(value))

    # -- live parameters (reference Parameter panel, example.zig:324-392) ---

    def param_specs(self, part: int) -> list:
        """The part's ParamSpecs ([] when the instrument exposes none)."""
        store = self.parts[part].params
        return [] if store is None else list(store.specs)

    def get_params(self, part: int) -> dict:
        store = self.parts[part].params
        return {} if store is None else dict(store.values)

    def _param_store(self, part: int):
        store = self.parts[part].params
        if store is None:
            raise ValueError(f"part {part}'s instrument exposes no live parameters")
        return store

    def _apply_params(self, part: _PartState, names) -> None:
        """Device-kind changes rebuild the f32 vector the next block
        uploads; every change is mirrored into the instrument config
        (apply_plan_params), and plan-kind ones invalidate the re-plan
        cache."""
        kinds = {part.params.by_name[n].kind for n in names}
        if kinds & {"device", "both"}:
            part.param_vec = np.asarray(
                part.instrument.device_params(part.params.values), np.float32)
        apply = getattr(part.instrument, "apply_plan_params", None)
        if apply is not None:
            apply(part.params.values)
        if kinds & {"plan", "both"}:
            part.plan_nonce += 1

    def set_param(self, part: int, name: str, value: int) -> int:
        """Set one parameter (clamped to its range); audible on the next
        block. Returns the stored value."""
        p = self.parts[part]
        store = self._param_store(part)
        with self._lock:
            v = store.set(name, value)
            self._apply_params(p, (name,))
        return v

    def step_param(self, part: int, name: str, delta: int) -> int:
        """Arrow-key stepping (example.zig:324-372)."""
        p = self.parts[part]
        store = self._param_store(part)
        with self._lock:
            v = store.step(name, delta)
            self._apply_params(p, (name,))
        return v

    def randomize_params(self, part: int, rng=None) -> dict:
        """Backspace-randomize every parameter (example.zig:373-391)."""
        import random

        p = self.parts[part]
        store = self._param_store(part)
        with self._lock:
            vals = store.randomize(rng or random.Random())
            self._apply_params(p, set(vals))
        return vals

    # -- block rendering: the host halves ----------------------------------

    def _extend_segments(self, part: _PartState) -> None:
        span = Span(0, self.block_size)
        iap = getattr(part, "_pending", None)
        if iap is None:
            iap = part.queue.consume()
        part._pending = None
        per_voice = part.dispatcher.dispatch(iap)
        for v in range(part.polyphony):
            for r in part.triggers[v].iterate(span, per_voice[v]):
                abs_start = self.frame + r.span.start
                prev = part.segs[v][-1] if part.segs[v] else None
                if prev is not None and not r.note_id_changed and prev[2] == r.params:
                    continue
                part.segs[v].append((abs_start, r.note_id_changed, r.params))
                if part.planner is not None:
                    part.planner.extend(v, abs_start, r.note_id_changed, r.params)

    def _timelines(self, part: _PartState, total: int) -> List[SubvoiceTimeline]:
        out = []
        for v in range(part.polyphony):
            segs = part.segs[v]
            out.append(SubvoiceTimeline(
                starts=np.array([s for s, _, _ in segs], dtype=np.int64),
                resets=np.array([r for _, r, _ in segs], dtype=bool),
                params=[p for _, _, p in segs],
                total=total,
            ))
        return out

    def _window_slice(self, prog, f0: int, f1: int, total: int):
        """SegProgram leaves -> {starts [V,KP] i32, name [V,KP]} covering
        [f0, f1), padded to slot_capacity with zero-delta rows."""
        if isinstance(prog, SegProgram):
            V, K = prog.starts.shape
            KP = self.slot_capacity
            firsts = np.empty(V, np.int64)
            lasts = np.empty(V, np.int64)
            for v in range(V):
                s = prog.starts[v]
                firsts[v] = max(np.searchsorted(s, f0, side="right") - 1, 0)
                lasts[v] = max(
                    min(np.searchsorted(s, f1, side="left"),
                        np.searchsorted(s, total, side="left")),
                    firsts[v] + 1,
                )
            count = int((lasts - firsts).max())
            if count > KP:
                if not liveplan.TRUNCATE_OVERFLOW:
                    raise RuntimeError(
                        f"live block needs {count} slots > slot_capacity={KP}; "
                        "raise slot_capacity (events per block are <= 32)"
                    )
                # degrade: drop the oldest overflow segments of this window
                firsts = np.maximum(firsts, lasts - KP)
            idx = firsts[:, None] + np.arange(KP)[None, :]
            in_w = idx < lasts[:, None]
            idx_v = np.minimum(np.maximum(np.minimum(idx, lasts[:, None] - 1), 0), K - 1)
            vix = np.arange(V)[:, None]
            out = {
                "starts": np.where(
                    in_w, prog.starts[vix, np.minimum(idx, K - 1)], np.int64(f1)
                ).astype(np.int32)
            }
            for name, arr in prog.values.items():
                out[name] = arr[vix, idx_v]
            return out
        if isinstance(prog, dict):
            return {k: self._window_slice(v, f0, f1, total) for k, v in prog.items()}
        if isinstance(prog, (list, tuple)):
            return type(prog)(self._window_slice(v, f0, f1, total) for v in prog)
        return prog

    def _part_progs(self, part: _PartState, f0: int, f1: int):
        if part.planner is not None:
            # incremental path: planners carry the walk state, so the
            # window costs O(slot_capacity), independent of session age
            return part.planner.window(f0, f1, self.slot_capacity)
        # plans are deterministic in (segments, horizon, controllers), so
        # blocks with no new events reuse the cached plan
        key = (tuple(len(sv) for sv in part.segs), self._horizon,
               part.plan_nonce,
               None if part.controllers is None else
               tuple(sorted((n, len(evs)) for n, evs in part.controllers.items())))
        if part.plan_cache is not None and part.plan_cache[0] == key:
            plan = part.plan_cache[1]
        else:
            tls = self._timelines(part, self._horizon)
            if part.controllers is not None:
                plan = part.instrument.plan(
                    tls, self.sample_rate,
                    controllers={n: list(evs) for n, evs in part.controllers.items()})
            else:
                plan = part.instrument.plan(tls, self.sample_rate)
            part.plan_cache = (key, plan)
        return self._window_slice(plan, f0, f1, self._horizon)

    def _host_block(self) -> Tuple[int, int]:
        """Host half 1: drain queues, extend segments, grow the horizon.
        Returns the block's (f0, f1)."""
        f0, f1 = self.frame, self.frame + self.block_size
        with self._lock:
            drained = [part.queue.consume() for part in self.parts]
        for part, iap in zip(self.parts, drained):
            part._pending = iap
        while self._horizon < f1:
            self._horizon *= 2
        for part in self.parts:
            self._extend_segments(part)
        return f0, f1

    def _window_progs(self, f0: int, f1: int):
        """Host half 2: each part's program window at the current
        slot_capacity, with its live-parameter vector (it rides the same
        upload, so a set_param costs nothing more). Raises
        RuntimeError('...slot_capacity...') on overflow: callers own the
        grow/degrade policy."""
        out = []
        for part in self.parts:
            prog = self._part_progs(part, f0, f1)
            if part.param_vec is not None:
                prog = dict(prog)
                prog[PARAMS] = part.param_vec
            out.append(prog)
        return out

    def _degraded_window_progs(self, f0: int, f1: int):
        """Windows with the oldest overflow segments dropped (the reference
        drops events past its 32-impulse cap, notes.zig:108-118)."""
        import warnings

        warnings.warn(
            f"live block overflows max_slot_capacity={self.max_slot_capacity}; "
            "dropping oldest segments for this block", RuntimeWarning)
        liveplan.TRUNCATE_OVERFLOW = True
        try:
            return self._window_progs(f0, f1)
        finally:
            liveplan.TRUNCATE_OVERFLOW = False

    def _grown_window_progs(self, f0: int, f1: int):
        """_window_progs, growing slot_capacity (doubling, up to its max)
        when a dense block overflows; past the max, degraded."""
        while True:
            try:
                return self._window_progs(f0, f1)
            except RuntimeError as e:
                if "slot_capacity" not in str(e):
                    raise
                if self.slot_capacity < self.max_slot_capacity:
                    self.slot_capacity = min(self.slot_capacity * 2,
                                             self.max_slot_capacity)
                    continue
                return self._degraded_window_progs(f0, f1)

    def _ensure_states(self) -> None:
        for part in self.parts:
            if part.dev_state is None:
                part.dev_state = part.instrument.init_state(part.polyphony, self.device)

    def pack_for(self, windows, lanes: int) -> BlockPack:
        """The BlockPack of these windows' layout (made anew when it changed,
        as after a slot-capacity growth)."""
        if self._pack is None or not self._pack.fits(windows, self.device, lanes):
            self._pack = BlockPack(windows[0], self.device, lanes)
        return self._pack

    # -- block rendering: the device step -------------------------------------

    def render_block_async(self) -> torch.Tensor:
        """Render the next block and return it on the device, [num_channels,
        block_size] f32, without waiting for it."""
        with span("block"):
            with span("block.windows"):
                f0, f1 = self._host_block()
                windows = self._grown_window_progs(f0, f1)
            self._ensure_states()
            with span("block.pack"):
                dev = self.pack_for([windows], 1).upload([f0], [windows])
            with span("block.launch"), card_context(self.device):
                states, posts, out = render_lanes(
                    [p.instrument for p in self.parts], [p.polyphony for p in self.parts],
                    [p.dev_state for p in self.parts], [self.post_state], dev, [f0],
                    windows, sample_rate=self.sample_rate, block_size=self.block_size,
                    num_channels=self.num_channels, post_fn=self.post_fn,
                    device=self.device)
            for p, st in zip(self.parts, states):
                p.dev_state = st
            self.post_state = posts[0]
            self.frame = f1
            return out[0]

    def render_block(self) -> np.ndarray:
        """Render the next block; returns f32 [num_channels, block_size]."""
        return self.render_block_async().cpu().numpy()

    def render_blocks(self, count: int) -> np.ndarray:
        return np.concatenate([self.render_block() for _ in range(count)], axis=1)

    # -- snapshot / restore (session migration) -----------------------------

    def _spec_fingerprint(self) -> tuple:
        # the instrument tag hashes CONFIG (public attrs, callables by
        # bytecode), not just the class name: restoring NiceInstrument(0.7)
        # state saved from NiceInstrument(0.3), or onto another script,
        # is refused
        from ..graph import aotcache

        return (
            self.sample_rate, self.block_size, self.num_channels,
            tuple((aotcache.stable_tag(p.instrument, strict=False),
                   p.polyphony, p.planner is not None) for p in self.parts),
            self.post_fn is not None,
        )

    def snapshot(self, dev_override=None) -> bytes:
        """The session's complete state (clock, note ids, queued events,
        dispatcher/trigger state, planner walks, device arrays as numpy) as
        a blob restorable on a fresh session of the same parts spec
        (host/snapshot.py; the continuation is bit for bit).

        dev_override: (per-part device states, post state) replacing the
        session's own: LiveFleet passes the lane's slice of its state."""
        from . import snapshot as snap

        with self._lock:
            if dev_override is not None:
                dev_states, post = dev_override
                dev_states = [to_numpy(d) for d in dev_states]
                post = to_numpy(post)
            else:
                dev_states = [None if p.dev_state is None else to_numpy(p.dev_state)
                              for p in self.parts]
                post = to_numpy(self.post_state)
            parts = [
                {
                    "queue": snap.extract_state(p.queue),
                    "dispatcher": snap.extract_state(p.dispatcher),
                    "triggers": snap.extract_state(p.triggers),
                    "segs": copy.deepcopy(p.segs),
                    "planner": (None if p.planner is None
                                else snap.extract_state(p.planner)),
                    "dev_state": dev,
                    "params": (None if p.params is None else dict(p.params.values)),
                    "controllers": copy.deepcopy(p.controllers),
                }
                for p, dev in zip(self.parts, dev_states)
            ]
            state = {
                "version": 1,
                "spec": self._pristine_spec,
                "frame": self.frame,
                "horizon": self._horizon,
                "slot_capacity": self.slot_capacity,
                "next_id": self.idgen.next_id,
                "held_keys": copy.deepcopy(self._held_keys),
                "post_state": post,
                "parts": parts,
            }
        return snap.dumps(state)

    def restore(self, blob: bytes) -> None:
        """Load a snapshot into this FRESH session (same parts spec; no
        events pushed, no blocks rendered). The next render_block continues
        the captured stream bit for bit. A refused restore leaves the
        session untouched."""
        from . import snapshot as snap

        state = snap.loads(blob)
        if state.get("version") != 1:
            raise ValueError(f"unknown snapshot version {state.get('version')}")
        if state["spec"] != self._pristine_spec:
            raise ValueError(
                f"snapshot spec mismatch: saved {state['spec']} vs this "
                f"session {self._pristine_spec}")
        for p, ps in zip(self.parts, state["parts"]):
            vals = ps.get("params")
            if vals is None:
                continue
            if p.params is None:
                raise ValueError(
                    "snapshot spec mismatch: saved session had live "
                    "parameters, this instrument exposes none")
            unknown = set(vals) - set(p.params.by_name)
            if unknown:
                raise ValueError(
                    f"snapshot spec mismatch: unknown parameter(s) {sorted(unknown)}")
        with self._lock:
            if self.frame != 0 or any(p.segs[v] for p in self.parts
                                      for v in range(p.polyphony)):
                raise ValueError("restore target must be a fresh session")
            for p, ps in zip(self.parts, state["parts"]):
                vals = ps.get("params")
                if vals is not None:
                    for k, v in vals.items():
                        p.params.set(k, v)
                    self._apply_params(p, set(vals))
            self.frame = state["frame"]
            self._horizon = state["horizon"]
            self.slot_capacity = max(self.slot_capacity, state["slot_capacity"])
            self.idgen.next_id = state["next_id"]
            self._held_keys = state["held_keys"]
            self.post_state = to_device(state["post_state"], self.device)
            for p, ps in zip(self.parts, state["parts"]):
                snap.graft_state(p.queue, ps["queue"])
                snap.graft_state(p.dispatcher, ps["dispatcher"])
                p.triggers = snap.graft_state(p.triggers, ps["triggers"])
                p.segs = ps["segs"]
                if ps["planner"] is not None:
                    snap.graft_state(p.planner, ps["planner"])
                p.dev_state = (None if ps["dev_state"] is None
                               else to_device(ps["dev_state"], self.device))
                if ps.get("controllers") is not None:
                    p.controllers = ps["controllers"]
                p.plan_cache = None
