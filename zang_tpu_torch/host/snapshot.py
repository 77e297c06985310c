"""Live-session snapshot/restore: migrate a playing session between hosts.

The reference has no session persistence (SURVEY.md §5 — "resume" is
init()); the serving tier needs it: draining a server, rebalancing lanes
across chips, or surviving a restart must not kill a musician's session.
The design makes this tractable — device state is a tree of small
arrays (values, not objects), and all host state (queues, dispatchers,
triggers, incremental planner walks) is plain data plus the callables the
instrument spec reconstructs.

The snapshot therefore separates STRUCTURE from STATE:

- structure (instruments, planner callables, jitted steps) is rebuilt by
  constructing a fresh LiveSession from the same parts spec;
- state (frame clock, note ids, segment histories, planner walk positions,
  device arrays) is extracted as a pure-data tree here and grafted onto the
  fresh session's objects.

`extract_state` walks an object graph and returns a picklable description:
data leaves (numbers, strings, numpy arrays, containers of those) are
deep-copied; callables are SKIPPED (the fresh twin keeps its own — they
are spec, not state); other objects recurse into their __dict__.
`graft_state` replays that description onto a structurally-identical
fresh object graph. Restoring into a mismatched spec raises.

Continuation is bit-exact: the restored session renders the same blocks
the original would have (tests/test_live_snapshot.py).

A copy of zang_tpu/host/snapshot.py (the port imports nothing of zang_tpu).
"""

import copy
import dataclasses
import pickle

import numpy as np

# attribute names that are structural back-references, never state
_SKIP_ATTRS = frozenset({"inst", "instrument"})

_SKIP = ("skip",)

_DATA_SCALARS = (bool, int, float, str, bytes, complex, np.generic)


def _is_data(obj) -> bool:
    """True if obj is plain data safe to deep-copy/pickle wholesale."""
    if obj is None or isinstance(obj, _DATA_SCALARS) or isinstance(
            obj, np.ndarray):
        return True
    if isinstance(obj, (list, tuple, set, frozenset)):
        return all(_is_data(x) for x in obj)
    if isinstance(obj, dict):
        return all(_is_data(k) and _is_data(v) for k, v in obj.items())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # all-data dataclasses (Impulse, SongEvent, dispatcher slots...) are
        # values: copy them wholesale so they can replace a fresh None
        return all(_is_data(v) for v in vars(obj).values())
    return False


def extract_state(obj):
    """Pure-data description of an object graph's mutable state. Its own
    walk, not tree.tree_map: it goes into objects, sets and dataclasses."""
    if callable(obj):
        return _SKIP
    if _is_data(obj):
        return ("v", copy.deepcopy(obj))
    if isinstance(obj, (list, tuple)):
        return ("seq", [extract_state(x) for x in obj])
    if isinstance(obj, dict):
        return ("map", {k: extract_state(v) for k, v in obj.items()})
    if hasattr(obj, "__dict__"):
        return ("obj", type(obj).__name__, {
            k: extract_state(v) for k, v in vars(obj).items()
            if k not in _SKIP_ATTRS
        })
    return _SKIP


def graft_state(target, state):
    """Replay an extract_state description onto a fresh object graph built
    from the same spec. Returns the (possibly replaced) value; objects are
    mutated in place. Raises ValueError on structural mismatch."""
    kind = state[0]
    if kind == "skip":
        return target
    if kind == "v":
        return state[1]
    if kind == "seq":
        items = state[1]
        if not isinstance(target, (list, tuple)) or len(target) != len(items):
            raise ValueError(
                f"snapshot structure mismatch: sequence of {len(items)} vs "
                f"{type(target).__name__}"
                f"[{len(target) if hasattr(target, '__len__') else '?'}]")
        new = [graft_state(t, s) for t, s in zip(target, items)]
        return tuple(new) if isinstance(target, tuple) else new
    if kind == "map":
        if not isinstance(target, dict):
            raise ValueError(
                f"snapshot structure mismatch: dict vs {type(target).__name__}")
        for k, s in state[1].items():
            if s[0] == "skip":
                continue
            if k in target:
                target[k] = graft_state(target[k], s)
            elif s[0] == "v":
                target[k] = s[1]
            else:
                raise ValueError(
                    f"snapshot structure mismatch: saved key {k!r} has no "
                    "fresh twin to graft onto")
        return target
    if kind == "obj":
        _, tname, attrs = state
        if type(target).__name__ != tname:
            raise ValueError(
                f"snapshot structure mismatch: {tname} vs "
                f"{type(target).__name__}")
        for k, s in attrs.items():
            if s[0] == "skip":
                continue
            cur = getattr(target, k, None)
            setattr(target, k, graft_state(cur, s))
        return target
    raise ValueError(f"unknown snapshot node {kind!r}")


def dumps(state: dict) -> bytes:
    return pickle.dumps(state, protocol=4)


def loads(blob: bytes) -> dict:
    """Deserialize a snapshot blob. Snapshots are pickle — only restore
    blobs your own servers produced (the same trust model as any
    checkpoint file)."""
    return pickle.loads(blob)
