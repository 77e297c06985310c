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

Elasticity: attach_lane()/detach_lane() admit and remove sessions from a
running fleet; growth doubles the lane count. prewarm=True renders one
throwaway block at the next size in a background thread (warmup), so
the kernels are built and the allocator holds the larger buffers before
a real block needs them.
"""

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..host.live import (
    LiveSession,
    card_context,
    folds,
    live_device,
    render_lanes,
    tree_map,
)


def _lane_rows(tree, lane: int, voices: int):
    """One lane's rows of a folded state."""
    return tree_map(lambda t: t[lane * voices:(lane + 1) * voices], tree)


def _set_lane_rows(tree, lane: int, voices: int, value) -> None:
    def put(t, v):
        t[lane * voices:(lane + 1) * voices] = v
    tree_map(put, tree, value)


class LiveFleet:
    """N concurrent live sessions rendered by one folded device step a block.

    make_parts: () -> [(instrument, polyphony)], called once a lane;
    session_kwargs pass through to each LiveSession (block_size,
    num_channels, post_fn/post_init_state, slot caps...). device: the card
    unless the caller asks for the CPU; every lane's session lives there.

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
        **session_kwargs,
    ) -> None:
        if num_lanes < 1:
            raise ValueError("num_lanes must be >= 1")
        self.device = live_device(device)
        self._make_parts = make_parts
        self._sample_rate = float(sample_rate)
        self._session_kwargs = dict(session_kwargs)
        self.lanes: List[LiveSession] = [self._new_session() for _ in range(num_lanes)]
        self._states = None  # a part's state: folded [L * V] leaves, or L lane states
        self._post_states = None  # L post states
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

    def _new_session(self) -> LiveSession:
        return LiveSession(self._make_parts(), self._sample_rate, device=self.device,
                           **self._session_kwargs)

    def _folded(self, L: Optional[int] = None) -> List[bool]:
        L = self.num_lanes if L is None else L
        return [folds(p.instrument, L) for p in self.lanes[0].parts]

    def reset_lane(self, lane: int) -> None:
        """Replace a lane with a fresh session (fresh queues, planners,
        clock); its device state re-initializes on the next block. Other
        lanes are untouched."""
        with self._lock:
            self.lanes[lane] = self._new_session()
            self._pending_reset.append(lane)

    def attach_lane(self) -> int:
        """Admit a new session to a running fleet; returns its lane id.

        Reuses a detached slot when one is free; otherwise the fleet GROWS
        (doubling): the folded state gets the new lanes' rows, and existing
        lanes render on unaffected."""
        with self._lock:
            if self._free:
                return self._free.pop()
        grow_by = max(1, len(self.lanes))
        first_new = len(self.lanes)
        new_sessions = [self._new_session() for _ in range(grow_by)]
        with self._lock:
            if self._states is not None:
                self._states, self._post_states = self._regrouped(
                    self._lane_states(range(len(self.lanes)))
                    + [self._session_states(s) for s in new_sessions],
                    len(self.lanes) + grow_by)
            self.lanes.extend(new_sessions)
            self._sync_capacity()
            self._free.update(range(first_new + 1, first_new + grow_by))
        if self._prewarm:
            self._prewarm_async(2 * len(self.lanes))
        return first_new

    def _session_states(self, s: LiveSession):
        """A fresh (or restored) session's own device state, on the card."""
        s._ensure_states()
        return [p.dev_state for p in s.parts], s.post_state

    def _lane_states(self, lanes):
        """(per-part states, post state) of each lane, sliced from the
        fleet's state."""
        folded = self._folded()
        out = []
        for lane in lanes:
            parts = []
            for p, (st, f) in enumerate(zip(self._states, folded)):
                V = self.lanes[0].parts[p].polyphony
                parts.append(_lane_rows(st, lane, V) if f else st[lane])
            out.append((parts, self._post_states[lane]))
        return out

    def _regrouped(self, per_lane, L: int):
        """The fleet's state for L lanes from each lane's (parts, post)."""
        folded = self._folded(L)
        states = []
        for p, f in enumerate(folded):
            lane_parts = [parts[p] for parts, _ in per_lane]
            states.append(tree_map(lambda *xs: torch.cat(xs), *lane_parts) if f
                          else list(lane_parts))
        return states, [post for _, post in per_lane]

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
        s = self._new_session()
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
            s = self._new_session()
            s.slot_capacity = self.lanes[0].slot_capacity
            f0, f1 = s._host_block()
            window = s._window_progs(f0, f1)
            per_lane = [self._session_states(s)]
            per_lane += [tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                  per_lane[0]) for _ in range(count - 1)]
            states, posts = self._regrouped(per_lane, count)
            pack = s.pack_for([window], count)
            dev = pack.upload([f0] * count, [window] * count)
            with card_context(self.device):
                _, _, out = render_lanes(
                    [p.instrument for p in s.parts], [p.polyphony for p in s.parts],
                    states, posts, dev, [f0] * count, window,
                    sample_rate=self._sample_rate, block_size=s.block_size,
                    num_channels=s.num_channels, post_fn=s.post_fn, device=self.device,
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
        for lane in resets:
            parts, post = self._session_states(self.lanes[lane])
            for p, (st, f) in enumerate(zip(self._states, folded)):
                if f:
                    V = self.lanes[0].parts[p].polyphony
                    _set_lane_rows(st, lane, V, parts[p])
                else:
                    st[lane] = parts[p]
            self._post_states[lane] = post

    def render_block_async(self) -> torch.Tensor:
        """Render every lane's next block on the card and return it there,
        [num_lanes, num_channels, block_size], without waiting for it."""
        spans, windows = self._collect_windows()
        self._init_states()
        ref = self.lanes[0]
        f0s = [f0 for f0, _ in spans]
        pack = ref.pack_for(windows, self.num_lanes)
        dev = pack.upload(f0s, windows)
        with card_context(self.device):
            self._states, self._post_states, out = render_lanes(
                [p.instrument for p in ref.parts], [p.polyphony for p in ref.parts],
                self._states, self._post_states, dev, f0s, windows[0],
                sample_rate=self._sample_rate, block_size=ref.block_size,
                num_channels=ref.num_channels, post_fn=ref.post_fn, device=self.device,
                pcm16_volume=self._pcm16_volume)
        for s, (_f0, f1) in zip(self.lanes, spans):
            s.frame = f1
        return out

    def render_block(self) -> np.ndarray:
        """Render every lane's next block: [num_lanes, num_channels,
        block_size], f32, or i16 PCM when pcm16_volume is set."""
        return self.render_block_async().cpu().numpy()

    def render_blocks(self, count: int) -> np.ndarray:
        """[num_lanes, num_channels, count * block_size]."""
        return np.concatenate([self.render_block() for _ in range(count)], axis=2)
