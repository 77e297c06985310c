"""The port's trees: nested dicts, lists and tuples of leaves.

Programs (SegProgram, numpy arrays, scalars), a chunk's slice of them
(arrays, WindowPlan, tensors), their tables (SegTable) and the render
state (tensors) are all such trees. The caller names the types that count
as leaves (`leaf`); with none named, every value that is not a dict, list
or tuple is one. Dicts are walked in their own order, lists and tuples in
order: that is the order of tree_leaves, which a chunk's packed buffer
relies on (graph/render.ChunkLayout).
"""

import torch

_SEQS = (list, tuple)


def tree_map(fn, tree, *rest, leaf=None):
    """tree with each leaf x replaced by fn(x, *the nodes of `rest` at x's
    place). With `leaf` given, a value of none of its types that is no dict,
    list or tuple stays as it is, and `rest` is not looked into there (a
    chunk's slice holds () where its program holds an array)."""
    if rest:
        return _map_zip(fn, tree, rest, leaf)
    return _map_all(fn, tree) if leaf is None else _map_some(fn, tree, leaf)


# one walk a case, so that a chunk's step pays for no test it does not need


def _map_some(fn, tree, leaf):
    if isinstance(tree, leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_some(fn, v, leaf) for k, v in tree.items()}
    if isinstance(tree, _SEQS):
        return type(tree)([_map_some(fn, v, leaf) for v in tree])
    return tree


def _map_all(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_all(fn, v) for k, v in tree.items()}
    if isinstance(tree, _SEQS):
        return type(tree)([_map_all(fn, v) for v in tree])
    return fn(tree)


def _map_zip(fn, tree, rest, leaf):
    if leaf is not None and isinstance(tree, leaf):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_zip(fn, v, [r[k] for r in rest], leaf) for k, v in tree.items()}
    if isinstance(tree, _SEQS):
        return type(tree)([_map_zip(fn, v, [r[i] for r in rest], leaf)
                           for i, v in enumerate(tree)])
    return tree if leaf is not None else fn(tree, *rest)


def tree_leaves(tree, leaf=None) -> list:
    """The leaves of tree in tree_map's order."""
    out = []
    _collect(tree, leaf, out)
    return out


def _collect(tree, leaf, out) -> None:
    if leaf is not None and isinstance(tree, leaf):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect(v, leaf, out)
    elif isinstance(tree, _SEQS):
        for v in tree:
            _collect(v, leaf, out)
    elif leaf is None:
        out.append(tree)


def tree_paths(tree, path=()):
    """(path, leaf) of every value that is no dict, list or tuple, in
    tree_map's order; a path is the tuple of keys and indices down to it."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (k,))
    elif isinstance(tree, _SEQS):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def tree_copy_(dst, src) -> None:
    """Copy every tensor of src into the tensor at the same place in dst.
    Raises ValueError where a list or tuple of src has another length."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            tree_copy_(v, src[k])
    elif isinstance(dst, _SEQS):
        if len(dst) != len(src):
            raise ValueError("a tree's structure changed: a list or tuple of "
                             f"{len(dst)} became one of {len(src)}")
        for d, s in zip(dst, src):
            tree_copy_(d, s)
