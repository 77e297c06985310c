"""Live serving fleet: many concurrent interactive sessions, one device pass
a part and block (port of zang_tpu/serve/live.py).

Every lane's block windows have the same shapes (one instrument spec, one
slot capacity), so the JAX package vmaps the session's block step over a
leading lane axis. torch.func.vmap cannot trace the kernels' ctypes
launches, so here the lane axis is FOLDED INTO THE VOICE AXIS instead: a
part's L lanes x V voices render as one [L * V, n] pass
(host/live.render_lanes), with

- a row of frames a voice (t_idx [L * V, n]): each lane keeps its own
  clock, so lanes may start at different times;
- the live-parameter vector a row a voice ([L, P] spread to [L * V, P]):
  a parameter set on one lane leaves the others' bits alone, and the FM
  kernel takes feedback and waveform a voice;
- the voice sum inside a lane over [L, V, n].

So the dense-cut SVF (K2) and the FM feedback kernel (K5) launch once a
part and block, whatever L is. A part whose instrument is not
lane_foldable (a zangscript instrument: its noise keys and its delay's
sub-chunk loop take a host scalar a lane) renders a lane at a time, and so
does the post chain.

Host state (queues, dispatchers, triggers, incremental planners, frame
clocks) stays a lane's own LiveSession. Device state lives folded between
blocks ([L * V] leaves a part), so the host work a block is L window
extractions (O(slot_capacity) each) and one packed upload of every lane's
windows from pinned memory.

Constraints: all lanes share one instrument spec (make_parts is called
once a lane so instruments carry no cross-lane state; lane 0's
instruments render), one block size, one sample rate and one slot
capacity (growth is fleet-wide and re-lays the packed upload). A lane can
be reset in place without touching the others.

Several devices (mesh=, zang_tpu/serve/live.py:68-88): the lanes split
into len(mesh.devices) contiguous groups, each with its own folded state
and BlockPack on its device, and render_lanes runs once a group and block,
every group launched before any is fetched. Lanes never interact, so there
is no collective, and no process: the host work stays this thread's (one
process a card is parallel/mesh.py's offline render). The lane count is a
multiple of the device count.

Elasticity: attach_lane()/detach_lane() admit and remove sessions from a
running fleet; growth doubles the lane count (in multiples of the device
count), and lanes whose group changes move to its device. prewarm=True
renders one throwaway block at the next size in a background thread
(warmup), so the kernels are built and the allocator holds the larger
buffers before a real block needs them.
"""

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..host.live import (
    BlockPack,
    LiveSession,
    card_context,
    folds,
    live_device,
    render_lanes,
)
from ..trace import span
from ..tree import tree_map


def _lane_rows(tree, lane: int, voices: int):
    """One lane's rows of a folded state."""
    return tree_map(lambda t: t[lane * voices:(lane + 1) * voices], tree)


def _set_lane_rows(tree, lane: int, voices: int, value) -> None:
    def put(t, v):
        t[lane * voices:(lane + 1) * voices] = v
    tree_map(put, tree, value)


def _to(tree, device):
    """The tree's tensors on `device` (the same tensors where they are)."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


class LiveFleet:
    """N concurrent live sessions rendered by one folded device step a block.

    make_parts: () -> [(instrument, polyphony)], called once a lane;
    session_kwargs pass through to each LiveSession (block_size,
    num_channels, post_fn/post_init_state, slot caps...). device: the card
    unless the caller asks for the CPU; every lane's session lives there.
    mesh: a parallel.Mesh instead (device is then not read): the lanes
    split into contiguous groups, one a mesh device; num_lanes must be a
    multiple of the mesh size.

    pcm16_volume: when set, the step mixes down to i16 PCM ON THE CARD
    (core.mixdown semantics) at that volume and render_block returns
    int16: half the download, which is what a PCM-streaming server ships.
    """

    def __init__(
        self,
        make_parts: Callable[[], Sequence],
        num_lanes: int,
        sample_rate: float,
        prewarm: bool = False,
        pcm16_volume: Optional[float] = None,
        device="cuda",
        mesh=None,
        **session_kwargs,
    ) -> None:
        if num_lanes < 1:
            raise ValueError("num_lanes must be >= 1")
        self.devices = ([live_device(d) for d in mesh.devices] if mesh is not None
                        else [live_device(device)])
        if num_lanes % len(self.devices):
            raise ValueError(f"num_lanes={num_lanes} must be a multiple of the mesh size "
                             f"({len(self.devices)}) to shard the lane axis")
        self.device = self.devices[0]  # where render_block_async gathers the groups
        self._make_parts = make_parts
        self._sample_rate = float(sample_rate)
        self._session_kwargs = dict(session_kwargs)
        self.lanes: List[LiveSession] = [
            self._new_session(self._lane_device(lane, num_lanes)) for lane in range(num_lanes)]
        # a group's part states (each folded [Lg * V] leaves, or Lg lane states)
        self._states = None
        self._post_states = None  # L post states, each on its lane's device
        self._packs = {}  # group -> its BlockPack
        self._pending_reset: List[int] = []
        self._free: set = set()  # detached lane slots, reusable by attach
        self._lock = threading.Lock()
        self._prewarm = bool(prewarm)
        self._pcm16_volume = None if pcm16_volume is None else float(pcm16_volume)
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_counts = set()

    # -- lane management ---------------------------------------------------

    @property
    def num_lanes(self) -> int:
        return len(self.lanes)

    @property
    def active_lanes(self) -> List[int]:
        return [i for i in range(len(self.lanes)) if i not in self._free]

    def _new_session(self, device) -> LiveSession:
        return LiveSession(self._make_parts(), self._sample_rate, device=device,
                           **self._session_kwargs)

    def _groups(self, L: int):
        """(first lane, end lane, device) of each group at L lanes."""
        G = len(self.devices)
        if L % G:
            raise ValueError(f"{L} lanes are not a multiple of the mesh size ({G})")
        return [(g * (L // G), (g + 1) * (L // G), d) for g, d in enumerate(self.devices)]

    def _lane_device(self, lane: int, L: int) -> torch.device:
        return self.devices[lane // (L // len(self.devices))]

    def _folded(self, L: Optional[int] = None) -> List[bool]:
        """Whether each part renders a group's lanes as one pass, at L lanes."""
        L = self.num_lanes if L is None else L
        return [folds(p.instrument, L // len(self.devices)) for p in self.lanes[0].parts]

    def reset_lane(self, lane: int) -> None:
        """Replace a lane with a fresh session (fresh queues, planners,
        clock); its device state re-initializes on the next block. Other
        lanes are untouched."""
        with self._lock:
            self.lanes[lane] = self._new_session(self._lane_device(lane, self.num_lanes))
            self._pending_reset.append(lane)

    def attach_lane(self) -> int:
        """Admit a new session to a running fleet; returns its lane id.

        Reuses a detached slot when one is free; otherwise the fleet GROWS
        (doubling, in multiples of the mesh size: zang_tpu/serve/live.py
        :141-146): the folded states get the new lanes' rows, lanes whose
        group changes move to its device, and existing lanes render on
        unaffected."""
        with self._lock:
            if self._free:
                return self._free.pop()
        G = len(self.devices)
        first_new = len(self.lanes)
        L = first_new + -(-max(1, first_new) // G) * G
        new_sessions = [self._new_session(self._lane_device(lane, L))
                        for lane in range(first_new, L)]
        with self._lock:
            if self._states is not None:
                self._states, self._post_states = self._regrouped(
                    self._lane_states(range(first_new))
                    + [self._session_states(s) for s in new_sessions], L)
            self.lanes.extend(new_sessions)
            self._sync_capacity()
            self._free.update(range(first_new + 1, L))
        if self._prewarm:
            self._prewarm_async(2 * len(self.lanes))
        return first_new

    def _session_states(self, s: LiveSession):
        """A fresh (or restored) session's own device state, on the card."""
        s._ensure_states()
        return [p.dev_state for p in s.parts], s.post_state

    def _lane_states(self, lanes):
        """(per-part states, post state) of each lane, sliced from its
        group's state."""
        folded = self._folded()
        size = self.num_lanes // len(self.devices)
        out = []
        for lane in lanes:
            g, j = divmod(lane, size)
            parts = []
            for p, (st, f) in enumerate(zip(self._states[g], folded)):
                V = self.lanes[0].parts[p].polyphony
                parts.append(_lane_rows(st, j, V) if f else st[j])
            out.append((parts, self._post_states[lane]))
        return out

    def _regrouped(self, per_lane, L: int):
        """The groups' states and the L post states for L lanes from each
        lane's (parts, post), moved to its group's device."""
        folded = self._folded(L)
        states, posts = [], []
        for lo, hi, dev in self._groups(L):
            group = [_to(lane, dev) for lane in per_lane[lo:hi]]
            part_states = []
            for p, f in enumerate(folded):
                lane_parts = [parts[p] for parts, _ in group]
                part_states.append(tree_map(lambda *xs: torch.cat(xs), *lane_parts) if f
                                   else list(lane_parts))
            states.append(part_states)
            posts += [post for _, post in group]
        return states, posts

    # -- lane migration (snapshot/restore) -----------------------------------

    def snapshot_lane(self, lane: int) -> bytes:
        """One lane's complete session state (host walks plus its rows of
        the fleet's device state) as a blob restorable on another fleet
        with the same instrument spec (host/snapshot.py). Not safe
        concurrent with render_block: callers serialize (LiveServer holds
        its lock)."""
        self._check_attached(lane)
        sess = self.lanes[lane]
        with self._lock:
            pending = lane in self._pending_reset
        if self._states is None or pending:
            return sess.snapshot()
        parts, post = self._lane_states([lane])[0]
        return sess.snapshot(dev_override=(parts, post))

    def restore_lane(self, lane: int, blob: bytes) -> None:
        """Replace a lane with a restored session; the lane continues the
        captured stream bit for bit on the next block. Accepts an attached
        or detached lane slot; slot capacity synchronizes fleet-wide."""
        s = self._new_session(self._lane_device(lane, self.num_lanes))
        s.restore(blob)
        with self._lock:
            self.lanes[lane] = s
            self._free.discard(lane)
            self._pending_reset.append(lane)
        self._sync_capacity()

    def detach_lane(self, lane: int) -> None:
        """Remove a session from the fleet; the slot renders silence and is
        reused by the next attach_lane. The fleet never shrinks."""
        if lane in self._free:
            raise ValueError(f"lane {lane} is already detached")
        self.reset_lane(lane)
        with self._lock:
            self._free.add(lane)

    def _check_attached(self, lane: int) -> None:
        if lane in self._free:
            raise ValueError(f"lane {lane} is detached — attach_lane() first")

    # -- warmup ---------------------------------------------------------------

    def warmup(self, lane_counts: Optional[Sequence[int]] = None) -> None:
        """Build the kernels and render one throwaway block at each lane
        count (default: the current count) from fresh sessions, without
        touching the fleet's lanes. Blocks until done."""
        counts = list(lane_counts) if lane_counts is not None else [self.num_lanes]
        for count in counts:
            s = self._new_session(self.device)
            s.slot_capacity = self.lanes[0].slot_capacity
            f0, f1 = s._host_block()
            window = s._window_progs(f0, f1)
            per_lane = [self._session_states(s)]
            per_lane += [tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                  per_lane[0]) for _ in range(count - 1)]
            states, posts = self._regrouped(per_lane, count)
            for g, (lo, hi, dev) in enumerate(self._groups(count)):
                n = hi - lo
                up = BlockPack(window, dev, n).upload([f0] * n, [window] * n)
                with card_context(dev):
                    _, _, out = render_lanes(
                        [p.instrument for p in s.parts], [p.polyphony for p in s.parts],
                        states[g], posts[lo:hi], up, [f0] * n, window,
                        sample_rate=self._sample_rate, block_size=s.block_size,
                        num_channels=s.num_channels, post_fn=s.post_fn, device=dev,
                        pcm16_volume=self._pcm16_volume)
                    out.cpu()
            self._warm_counts.add(count)

    def _prewarm_async(self, lane_count: int) -> None:
        """Warm the NEXT growth size in the background."""
        if lane_count in self._warm_counts or (
                self._warm_thread is not None and self._warm_thread.is_alive()):
            return

        def work():
            try:
                self.warmup([lane_count])
            except Exception:  # noqa: BLE001 — warmup is advisory only
                pass

        self._warm_thread = threading.Thread(target=work, daemon=True)
        self._warm_thread.start()

    def close(self, timeout: Optional[float] = None) -> None:
        """Join any in-flight background warmup."""
        if self._warm_thread is not None:
            self._warm_thread.join(timeout=timeout)

    # -- event input (delegates) ------------------------------------------

    def push_event(self, lane: int, part: int, params: dict,
                   note_id: Optional[int] = None, impulse_frame: int = 0) -> int:
        self._check_attached(lane)
        return self.lanes[lane].push_event(part, params, note_id, impulse_frame)

    def key_event(self, lane: int, part: int, key: str, down: bool, **kw) -> Optional[int]:
        self._check_attached(lane)
        return self.lanes[lane].key_event(part, key, down, **kw)

    def push_controller(self, lane: int, part: int, name: str, value: float) -> None:
        """Continuous-controller move (mouse path) for one lane."""
        self._check_attached(lane)
        self.lanes[lane].push_controller(part, name, value)

    # -- live parameters (delegates; host/params.py) -------------------------
    # A lane's f32 vector rides the fleet's one packed upload a block, so a
    # change on one lane costs the other lanes nothing.

    def param_specs(self, lane: int, part: int = 0) -> list:
        self._check_attached(lane)
        return self.lanes[lane].param_specs(part)

    def get_params(self, lane: int, part: int = 0) -> dict:
        self._check_attached(lane)
        return self.lanes[lane].get_params(part)

    def set_param(self, lane: int, part: int, name: str, value: int) -> int:
        self._check_attached(lane)
        return self.lanes[lane].set_param(part, name, value)

    def step_param(self, lane: int, part: int, name: str, delta: int) -> int:
        self._check_attached(lane)
        return self.lanes[lane].step_param(part, name, delta)

    def randomize_params(self, lane: int, part: int = 0, rng=None) -> dict:
        self._check_attached(lane)
        return self.lanes[lane].randomize_params(part, rng=rng)

    # -- block rendering ---------------------------------------------------

    def _sync_capacity(self) -> int:
        cap = max(s.slot_capacity for s in self.lanes)
        for s in self.lanes:
            s.slot_capacity = cap
        return cap

    def _collect_windows(self):
        """Host halves for every lane with the fleet-wide capacity policy."""
        spans = [s._host_block() for s in self.lanes]
        self._sync_capacity()
        while True:
            try:
                windows = [s._window_progs(f0, f1) for s, (f0, f1) in zip(self.lanes, spans)]
                return spans, windows
            except RuntimeError as e:
                if "slot_capacity" not in str(e):
                    raise
                ref = self.lanes[0]
                if ref.slot_capacity < ref.max_slot_capacity:
                    grown = min(ref.slot_capacity * 2, ref.max_slot_capacity)
                    for s in self.lanes:
                        s.slot_capacity = grown
                    continue
                windows = []
                for s, (f0, f1) in zip(self.lanes, spans):
                    try:
                        windows.append(s._window_progs(f0, f1))
                    except RuntimeError as e2:
                        if "slot_capacity" not in str(e2):
                            raise
                        windows.append(s._degraded_window_progs(f0, f1))
                return spans, windows

    def _init_states(self) -> None:
        """(Re)build the folded device state for fresh or reset lanes."""
        with self._lock:
            resets, self._pending_reset = self._pending_reset, []
        if self._states is None:
            self._states, self._post_states = self._regrouped(
                [self._session_states(s) for s in self.lanes], self.num_lanes)
            return
        folded = self._folded()
        size = self.num_lanes // len(self.devices)
        for lane in resets:
            g, j = divmod(lane, size)
            parts, post = _to(self._session_states(self.lanes[lane]), self.devices[g])
            for p, (st, f) in enumerate(zip(self._states[g], folded)):
                if f:
                    V = self.lanes[0].parts[p].polyphony
                    _set_lane_rows(st, j, V, parts[p])
                else:
                    st[j] = parts[p]
            self._post_states[lane] = post

    def _pack(self, g: int, windows, device) -> BlockPack:
        """Group g's BlockPack, made anew when it no longer fits."""
        pack = self._packs.get(g)
        if pack is None or not pack.fits(windows, device, len(windows)):
            pack = self._packs[g] = BlockPack(windows[0], device, len(windows))
        return pack

    def render_block_async(self) -> torch.Tensor:
        """Render every lane's next block and return it on the (first) card,
        [num_lanes, num_channels, block_size], without waiting for it: every
        group is launched before any is gathered."""
        with span("block"):
            with span("block.windows"):
                spans, windows = self._collect_windows()
            self._init_states()
            ref = self.lanes[0]
            f0s = [f0 for f0, _ in spans]
            outs = []
            for g, (lo, hi, dev) in enumerate(self._groups(self.num_lanes)):
                with span("block.pack"):
                    up = self._pack(g, windows[lo:hi], dev).upload(f0s[lo:hi], windows[lo:hi])
                with span("block.launch"), card_context(dev):
                    self._states[g], self._post_states[lo:hi], out = render_lanes(
                        [p.instrument for p in ref.parts], [p.polyphony for p in ref.parts],
                        self._states[g], self._post_states[lo:hi], up, f0s[lo:hi],
                        windows[lo], sample_rate=self._sample_rate,
                        block_size=ref.block_size, num_channels=ref.num_channels,
                        post_fn=ref.post_fn, device=dev, pcm16_volume=self._pcm16_volume)
                outs.append(out)
            for s, (_f0, f1) in zip(self.lanes, spans):
                s.frame = f1
            if len(outs) == 1:
                return outs[0]
            return torch.cat([o.to(self.device, non_blocking=True) for o in outs])

    def render_block(self) -> np.ndarray:
        """Render every lane's next block: [num_lanes, num_channels,
        block_size], f32, or i16 PCM when pcm16_volume is set."""
        return self.render_block_async().cpu().numpy()

    def render_blocks(self, count: int) -> np.ndarray:
        """[num_lanes, num_channels, count * block_size]."""
        return np.concatenate([self.render_block() for _ in range(count)], axis=2)
