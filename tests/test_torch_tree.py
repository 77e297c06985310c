"""The port's trees (zang_tpu_torch/tree.py) and the device dtype rule
(zang_tpu_torch/device.py), on the CPU.

- tree_map keeps dicts, lists and tuples as they are and maps the leaves of
  the types it is given (every value that is no container when none is);
  other values stay.
- Several trees zip along the first; where the first holds a value that is
  not a leaf, the others are not looked into (a chunk's slice holds () in
  an array's place).
- tree_leaves is tree_map's order, which a ChunkLayout packs in.
- tree_paths names each leaf's place; tree_copy_ copies in place and
  refuses a changed structure.
- to_device: u32 rides int64, one "h2d.copies" a call.
"""

import numpy as np
import pytest
import torch

from zang_tpu_torch import trace
from zang_tpu_torch.device import arrays_to_device, device_dtype, to_device
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.host import live as tlive
from zang_tpu_torch.host import song as tsong
from zang_tpu_torch.ops.segprog import SegProgram, WindowPlan
from zang_tpu_torch.ops.tile_windows import SegTable
from zang_tpu_torch.tree import tree_copy_, tree_leaves, tree_map, tree_paths

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SP = SegProgram(starts=np.zeros((2, 3), np.int64), values={"v": np.ones((2, 3), np.float32)})
PLAN = WindowPlan(S=2, nt=4, tile=512, total=4096)
TABLE = SegTable(starts=torch.zeros((2, 3), dtype=torch.int32),
                 values={"v": torch.ones((2, 3))})
ARRAY = np.arange(4, dtype=np.float32)
TENSOR = torch.arange(3)


class Mapped:
    def __init__(self, x) -> None:
        self.x = x


def _tree():
    return [{"a": ARRAY, "b": (SP, 0.5, [TENSOR, PLAN])}, (TABLE, "s", {"c": ARRAY})]


@pytest.mark.parametrize("leaf", [np.ndarray, torch.Tensor, SegProgram, WindowPlan, SegTable,
                                  (np.ndarray, torch.Tensor), None],
                         ids=lambda t: getattr(t, "__name__", str(t)))
def test_tree_map_maps_the_leaves_of_its_types_and_keeps_the_containers(leaf):
    tree = _tree()
    got = tree_map(Mapped, tree, leaf=leaf)
    assert type(got) is list and type(got[0]) is dict and type(got[1]) is tuple
    assert type(got[0]["b"]) is tuple and type(got[0]["b"][2]) is list
    assert list(got[0]) == ["a", "b"]
    for (_, old), (_, new) in zip(tree_paths(tree), tree_paths(got)):
        if leaf is None or isinstance(old, leaf):
            assert isinstance(new, Mapped) and new.x is old
        else:
            assert new is old


def test_tree_map_zips_trees_along_the_first():
    """The live host's case (every leaf, three trees) and the chunk's: a
    program's SegPrograms replaced by the chunk slice's nodes, where the
    slice holds () in an array's place."""
    a = {"x": [1, 2], "y": (3,)}
    b = {"x": [10, 20], "y": (30,), "z": "not walked"}
    assert tlive.tree_map(lambda p, q, r: p + q + r, a, b, b) == {"x": [21, 42], "y": (63,)}
    prog = [{"phase": SP, "color": ARRAY, "n": 3}, (SP,)]
    xs = [{"phase": {"tb": ARRAY}, "color": (), "n": ()}, ({"tb": TENSOR},)]
    got = tree_map(lambda _, x: x, prog, xs, leaf=SegProgram)
    assert got[0]["phase"] == {"tb": ARRAY} and got[1][0] == {"tb": TENSOR}
    assert got[0]["color"] is ARRAY and got[0]["n"] == 3


@pytest.mark.parametrize("chunk", [8192, 7000], ids=["tiled", "flat"])
def test_tree_leaves_is_tree_maps_order_and_a_layouts(chunk):
    perf = tsong.build_performance(24000)
    xs, _ = trender.host_slices(perf, 24000, chunk)
    xs0 = trender.chunk_slice(xs, 0)
    leaves = tree_leaves(xs0, trender.ARRAYS)
    seen = []
    tree_map(seen.append, xs0, leaf=trender.ARRAYS)
    assert len(leaves) == len(seen) > 0 and all(a is b for a, b in zip(leaves, seen))
    layout = trender.ChunkLayout(xs0)
    assert [(shape, dtype) for _, shape, dtype in layout.places] == [
        (a.shape, device_dtype(a)) for a in leaves]
    assert tree_leaves(layout.template, int) == list(range(len(leaves)))


def test_tree_paths_name_every_leaf_in_order():
    tree = {"a": [1, (2, {"b": 3})], "c": 4, "d": ()}
    assert list(tree_paths(tree)) == [(("a", 0), 1), (("a", 1, 0), 2),
                                      (("a", 1, 1, "b"), 3), (("c",), 4)]
    assert list(tree_paths(tree, ("p",)))[0] == (("p", "a", 0), 1)
    assert [v for _, v in tree_paths(tree)] == tree_leaves(tree)


@pytest.mark.parametrize("src", [([torch.zeros(1), torch.zeros(1)], ()), ([torch.zeros(1)], (1,)),
                                 ((torch.zeros(1),), ())],
                         ids=["longer list", "longer tuple", "same lengths"])
def test_tree_copy_copies_in_place_and_refuses_a_changed_structure(src):
    dst = ([torch.ones(1)], ())
    kept = dst[0][0]
    if [len(x) for x in src] != [len(x) for x in dst]:
        with pytest.raises(ValueError, match="structure"):
            tree_copy_(dst, src)
    else:
        tree_copy_(dst, src)
        assert dst[0][0] is kept and torch.equal(kept, torch.zeros(1))


@pytest.mark.parametrize("dtype,want", [(np.uint32, torch.int64), (np.float32, torch.float32),
                                        (np.int32, torch.int32), (np.int64, torch.int64)])
def test_to_device_puts_u32_in_int64_and_counts_one_copy(dtype, want):
    a = np.array([0, 1, 2 ** 31 - 1], dtype)
    if dtype == np.uint32:
        a[2] = np.uint32(2 ** 32 - 1)  # a u32 past int32's range keeps its value
    before = trace.counters().get("h2d.copies", 0)
    t = to_device(a, "cpu")
    assert trace.counters()["h2d.copies"] - before == 1
    assert t.dtype == want == device_dtype(a)
    assert t.tolist() == a.tolist()
    tree = arrays_to_device({"a": [a, 7]}, "cpu")
    assert tree["a"][0].dtype == want and tree["a"][1] == 7
