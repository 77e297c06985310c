"""stable_tag: a process-stable fingerprint of an instrument spec (port of
stable_tag and Uncacheable from zang_tpu/graph/aotcache.py).

The JAX package's module is a disk cache of compiled XLA executables; the
port has nothing to cache (eager torch, kernels built once from source),
so only the fingerprint is kept. LiveSession keys its snapshots with it:
a snapshot restores only onto a session of the same spec.
"""

import hashlib

import torch


class Uncacheable(Exception):
    """stable_tag could not fingerprint part of the object (unhashable
    receiver/default/closure capture). A key built from a degraded repr
    could collide across distinct configs, so a caller that keys anything
    durable on it must catch this (strict=False degrades instead)."""


def _code_fingerprint(code) -> str:
    """Process-stable hash of a code object's BEHAVIOR: bytecode, names,
    and constants (co_code alone misses constant-only edits — two lambdas
    differing only in a literal share opcode streams). Nested code objects
    (inner defs/lambdas/comprehensions) recurse — their default repr
    embeds a memory address and must not leak into the hash."""
    h = hashlib.sha1()
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr(code.co_varnames).encode())
    for c in code.co_consts:
        if hasattr(c, "co_code"):
            h.update(_code_fingerprint(c).encode())
        else:
            h.update(repr(c).encode())
    return h.hexdigest()


def stable_tag(obj, strict: bool = True) -> str:
    """A process-stable description of anything that shapes a traced graph
    (instrument configs, callables, chunk policy...). Unlike
    serve.batch._leaf_key, callables hash by (module, qualname, bytecode)
    instead of id(), so two processes tag one spec alike. Opaque
    non-callable objects hash by repr of their public attrs.

    strict=True (the default, for disk keys): any value that cannot be
    walked raises Uncacheable instead of degrading to a type repr — two
    differently-configured receivers of one class must never collide onto
    one disk key. strict=False (snapshot fingerprints, where a refused
    restore is worse than a theoretical collision) keeps the degraded
    repr fallbacks.

    Cyclic object graphs are fingerprinted, not refused: a back-edge to an
    object already on the current descent path encodes as ("cycle", k)
    where k is the ancestor's distance up the path — structural, so two
    isomorphic graphs tag identically. (Script parse trees are the live
    case: Scope.parent points back at the enclosing scope, so any DSL
    module using delay/deftrack is cyclic; stable_tag used to recurse
    forever on those.) Shared acyclic substructure (a DAG diamond) is NOT
    on the path twice and still walks fully both times."""

    _onpath: dict = {}

    def walk(v):
        import numpy as np

        if isinstance(v, np.generic):
            return ("s", v.dtype.str, v.item())
        if isinstance(v, (bool, int, float, str, bytes, type(None))):
            return ("s", type(v).__name__, v)
        if isinstance(v, (np.ndarray, torch.Tensor)):
            a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            return ("a", a.shape, str(a.dtype),
                    hashlib.sha1(np.ascontiguousarray(a).tobytes())
                    .hexdigest())
        # everything below can recurse — break cycles on the descent path
        vid = id(v)
        if vid in _onpath:
            return ("cycle", len(_onpath) - _onpath[vid])
        _onpath[vid] = len(_onpath)
        try:
            return walk_acyclic(v)
        finally:
            del _onpath[vid]

    def walk_acyclic(v):
        import numpy as np

        if isinstance(v, (list, tuple)):
            return ("l", tuple(walk(x) for x in v))
        if isinstance(v, dict):
            return ("d", tuple(sorted((k, walk(x)) for k, x in v.items())))
        if callable(v):
            import functools

            if isinstance(v, functools.partial):
                # partial has no __code__/__closure__; its identity is the
                # wrapped callable plus the bound args
                return ("p", walk(v.func), walk(list(v.args)),
                        walk(dict(v.keywords)))
            extras = []
            bound = getattr(v, "__self__", None)
            if bound is not None:  # bound method: instance state shapes it
                try:
                    extras.append(("self", walk(bound)))
                except Uncacheable:
                    raise
                except Exception as e:  # noqa: BLE001 — unhashable receiver
                    if strict:
                        raise Uncacheable(
                            f"bound-method receiver {type(bound)!r} cannot "
                            f"be fingerprinted") from e
                    extras.append(("self?", repr(type(bound))))
            for attr in ("__defaults__", "__kwdefaults__"):
                d = getattr(v, attr, None)
                if d:
                    try:
                        extras.append((attr, walk(list(d) if attr ==
                                                  "__defaults__" else d)))
                    except Uncacheable:
                        raise
                    except Exception as e:  # noqa: BLE001
                        if strict:
                            raise Uncacheable(
                                f"{attr} of {v!r} cannot be "
                                f"fingerprinted") from e
                        extras.append((attr + "?", repr(d)))
            code = getattr(v, "__code__", None)
            if code is None and not isinstance(v, type):
                # callable instance (__call__): its public attrs are the
                # config — without them two differently-configured
                # instances of one class would collide
                extras.append(("attrs", tuple(sorted(
                    (k, walk(x)) for k, x in getattr(v, "__dict__", {}).items()
                    if not k.startswith("_")))))
            body = _code_fingerprint(code) if code else ""
            cells = getattr(v, "__closure__", None) or ()
            captured = []
            for cell in cells:
                try:
                    captured.append(walk(cell.cell_contents))
                except Uncacheable:
                    raise
                except Exception as e:  # noqa: BLE001 — unhashable capture
                    if strict:
                        raise Uncacheable(
                            f"closure capture {type(cell.cell_contents)!r} "
                            f"cannot be fingerprinted") from e
                    captured.append(("?", repr(type(cell.cell_contents))))
            return ("f", getattr(v, "__module__", ""),
                    getattr(v, "__qualname__", type(v).__name__), body,
                    tuple(captured), tuple(extras))
        pub = tuple(sorted(
            (k, walk(x)) for k, x in getattr(v, "__dict__", {}).items()
            if not k.startswith("_")))
        return ("o", type(v).__module__, type(v).__qualname__, pub)

    return repr(walk(obj))
