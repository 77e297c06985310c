"""Interactive-host utilities: parameters, recorder, reload watching.

Offline counterparts of the reference's SDL-host features:
- Parameter (examples/common.zig:9-14 + example.zig:324-392): integer-valued
  live parameters with arrow-key stepping and Backspace randomization
  (favor_low_values biases the randomizer toward small values).
- Recorder (examples/recorder.zig:18-170): record a keypress performance,
  then loop it back with preserved relative timing.
- watch_script (watch_script.sh + example.zig:89-133): file watching and an
  optional UDP "reload" listener driving LiveScript reloads.

A copy of zang_tpu/host/interaction.py (the port imports nothing of zang_tpu).
"""

import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass
class Parameter:
    """A live-tweakable integer parameter (common.zig:9-14)."""

    desc: str
    num_values: int
    current_value: int = 0
    favor_low_values: bool = False

    def step(self, delta: int) -> int:
        self.current_value = max(0, min(self.num_values - 1,
                                        self.current_value + delta))
        return self.current_value

    def randomize(self, rng) -> int:
        # example.zig:373-391: favor_low_values squares the uniform draw
        u = rng.random()
        if self.favor_low_values:
            u = u * u
        self.current_value = min(self.num_values - 1,
                                 int(u * self.num_values))
        return self.current_value


MAX_RECORDER_NOTES = 5000  # recorder.zig:43
MAX_RECORDER_KEYS_HELD = 50  # recorder.zig:44


@dataclass
class Recorder:
    """Keypress record/loop-playback state machine (recorder.zig:18-170).

    States: idle -> recording -> playing (loops the recorded events with
    preserved timing) -> idle, cycled by one key (the reference's
    backquote, example.zig:393-400). As in the reference, every state
    transition and every loop restart first DRAINS the held keys —
    key-ups are emitted for everything in keys_held so notes never stick
    across a mode change or a loop boundary (recorder.zig getNote:107-144).
    track_event() maintains keys_held for both live and playback events
    (example.zig:435 + recorderPlayback example.zig:514-526).
    """

    state: str = "idle"
    # key is whatever the host uses (SDL keycode ints in the
    # reference; key-character strings in the terminal client)
    events: List[Tuple[float, object, bool]] = field(default_factory=list)
    keys_held: List[object] = field(default_factory=list)
    _record_start: float = 0.0
    _loop_length: float = 0.0
    _play_start: float = 0.0
    _play_index: int = 0
    _drain: bool = False
    _looping: bool = False

    def start_recording(self, now: float) -> None:
        self.state = "recording"
        self.events = []
        self._record_start = now

    def record_event(self, now: float, key, down: bool) -> bool:
        if self.state != "recording":
            return False
        if len(self.events) >= MAX_RECORDER_NOTES:
            return False  # silently full, like the reference
        self.events.append((now - self._record_start, key, down))
        return True

    def track_event(self, key, down: bool) -> None:
        """Maintain the held-key set (recorder.zig trackEvent:87-104);
        call for live AND playback events that the instrument accepted."""
        if down:
            if key not in self.keys_held and \
                    len(self.keys_held) < MAX_RECORDER_KEYS_HELD:
                self.keys_held.append(key)
        else:
            try:
                self.keys_held.remove(key)
            except ValueError:
                pass

    def cycle_mode(self) -> None:
        """The backquote press (recorder.zig cycleMode:68-70): request a
        drain; the state transition runs once the drain completes inside
        the next poll()."""
        self._drain = True

    def start_playing(self, now: float, loop_length: Optional[float] = None) -> None:
        self.state = "playing"
        if loop_length is None:
            loop_length = (self.events[-1][0] + 0.25) if self.events else 0.0
        self._loop_length = loop_length
        self._play_start = now
        self._play_index = 0
        self._looping = False

    @property
    def loop_seconds(self) -> float:
        return self._loop_length

    def _get_note(self, now: float) -> Optional[Tuple[object, bool]]:
        """One event if due, else None (recorder.zig getNote:106-170)."""
        if self._drain:
            if self.keys_held:
                return (self.keys_held.pop(), False)
            self._drain = False
            if self.state == "idle":
                self.start_recording(now)
            elif self.state == "recording":
                self.start_playing(
                    now, loop_length=now - self._record_start)
            elif self.state == "playing":
                if self._looping:  # drain came from a loop restart
                    self._looping = False
                else:  # drain came from the user's cycle press
                    self.state = "idle"
        if self.state != "playing":
            return None
        if now - self._play_start >= self._loop_length:
            self._play_index = 0
            self._play_start = now
            self._looping = True
            self._drain = True  # drain held keys at the loop seam
        # DELIBERATE divergence from the reference at the seam: getNote
        # computes `time` BEFORE the restart (recorder.zig:152-157) and
        # still checks notes[0] against that stale value (:160-168), so
        # the reference emits the loop's first event immediately at the
        # seam — and the held-key drain on the very next call then
        # releases that key, cutting the first note of every loop pass
        # to zero length. We re-time from the new loop start instead:
        # the drain runs first and the first note replays at its
        # recorded offset, intact.
        if self._play_index < len(self.events):
            t, key, down = self.events[self._play_index]
            if t <= now - self._play_start:
                self._play_index += 1
                return (key, down)
        return None

    def poll(self, now: float) -> List[Tuple[object, bool]]:
        """All events due at `now` (the reference host's
        `while getNote()` pump, example.zig:515); loops when the loop
        length elapses, draining held keys at each seam."""
        out = []
        while True:
            n = self._get_note(now)
            if n is None:
                return out
            out.append(n)

    def stop(self) -> None:
        self.state = "idle"
        self._drain = False
        self._looping = False


class ReloadWatcher:
    """Drive LiveScript reloads from file mtime changes and/or UDP 'reload'
    messages (the ZANG_LISTEN_PORT flow, example.zig:89-133,225-238)."""

    def __init__(self, live_script, udp_port: Optional[int] = None):
        self.live = live_script
        self.udp_port = udp_port
        self._sock = None
        self._stop = threading.Event()
        self._thread = None
        self.reload_count = 0
        if udp_port is None and os.environ.get("ZANG_LISTEN_PORT"):
            self.udp_port = int(os.environ["ZANG_LISTEN_PORT"])

    def poll(self) -> bool:
        """Check for file changes (call periodically). True if reloaded OK."""
        if self.live.maybe_reload():
            self.reload_count += 1
            return True
        return False

    def start_udp(self) -> None:
        assert self.udp_port is not None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", self.udp_port))
        self._sock.settimeout(0.2)

        def loop():
            while not self._stop.is_set():
                try:
                    data, _ = self._sock.recvfrom(64)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if data.strip() == b"reload":
                    if self.live.reload():
                        self.reload_count += 1

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        if self._sock:
            self._sock.close()
