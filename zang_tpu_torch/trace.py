"""The port's spans and counters: one in-memory recorder for the whole
package.

Spans. `with span("chunk.upload"):` marks a layer's work on the host. The
recorder is off by default, and then `span` does one check and returns a
shared no-op context: no allocation, no clock read, no profiler range. It
records while it is on, which is

- between enable() and disable(), and
- while a torch.profiler is running (the profiler is the caller's request
  to trace: its trace holds every span as a "zt.<name>" range, on the
  profiler's clock beside the device's ops, and records() holds the same
  spans, so a profiled region reads the same either way).

A record is (name, id, parent, root, thread, t0, t1): t0 and t1 are
time.perf_counter_ns, the clock time.perf_counter reads in nanoseconds;
parent is the id of the span open around it on its thread (0 for none);
root that of the outermost one, so the spans of one block, one chunk or
one job's planning share it. Each thread keeps its own stack. Records go
to a deque of CAPACITY; the oldest is dropped past it, and dropped() counts
them. Nothing is written out: records() reads them, take() reads and
clears them.

Counters. count(name, n) adds to a plain dict of ints, always on (a dict
add a call): "h2d.copies" (each host-to-device copy of a chunk's or a
block's inputs), "chunks" (each chunk step) and "launch.<kernel>" (each
launch of a hand-written kernel; parallel/mesh.launch_counts reads them).
"""

import collections
import itertools
import threading
import time
from contextlib import nullcontext
from typing import List, NamedTuple

import torch
import torch.autograd.profiler as _profiler_state

CAPACITY = 1 << 17

_on = False
_NULL = nullcontext()
_records = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_counters = {}
_count_lock = threading.Lock()  # threads count too (serving workers launch)


class Record(NamedTuple):
    name: str
    id: int
    parent: int
    root: int
    thread: int
    t0: int  # ns, time.perf_counter_ns
    t1: int


def enable() -> None:
    """Record every span from now on (the records kept so far stay)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording (a running torch.profiler still records)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on or _profiler_state._is_profiler_enabled


class _Span:
    __slots__ = ("name", "id", "parent", "root", "t0", "range")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
        stack.append(self)
        self.range = None
        if _profiler_state._is_profiler_enabled:
            self.range = torch.profiler.record_function("zt." + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if len(_records) == CAPACITY:
            _dropped += 1
        _records.append(Record(self.name, self.id, self.parent, self.root,
                               threading.get_ident(), self.t0, t1))
        return False


def span(name: str):
    """A context that records `name` while the recorder is on (see the
    module's docstring), and does nothing otherwise."""
    if not (_on or _profiler_state._is_profiler_enabled):
        return _NULL
    return _Span(name)


def records() -> List[Record]:
    """The records kept, oldest first."""
    return list(_records)


def take() -> List[Record]:
    """The records kept, oldest first, and none kept after."""
    out = []
    while _records:
        out.append(_records.popleft())
    return out


def dropped() -> int:
    """How many records the deque's bound has dropped in this process."""
    return _dropped


def self_ns(recs) -> dict:
    """{id: the span's duration less the time its direct children cover}
    over `recs` (children on the span's thread nest inside it)."""
    out = {r.id: r.t1 - r.t0 for r in recs}
    for r in recs:
        if r.parent in out:
            out[r.parent] -= r.t1 - r.t0
    return out


# ---------------------------------------------------------------------------
# counters


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    with _count_lock:
        return dict(_counters)


def reset_counters(prefix: str = "") -> None:
    """Set the counters whose names start with `prefix` (every one by
    default) to 0."""
    with _count_lock:
        for k in _counters:
            if k.startswith(prefix):
                _counters[k] = 0
