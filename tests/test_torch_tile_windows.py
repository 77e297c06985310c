"""Tile windows cut from a SegProgram's [V, K] tables (zang_tpu_torch/ops/
tile_windows.py, ops/segprog.py plan_windows) on the CPU; the kernel's
cases are in tests/test_torch_cuda_paths.py.

- The plain version of the cut is chunkify_tiled's slice of every chunk,
  the partial last one included, bit for bit and dtype for dtype: the
  Toccata's four programs and a 256-voice texture's two, at chunks of
  65,536 and 8,192 frames, and programs drawn to hit the edges (starts at
  and past total, on tile boundaries, a voice of one segment, a first
  start after 0, starts before 0, repeated starts).
- The window plan's slot count S is chunkify_tiled's in every case.
- A render through the plans is the host-sliced step's render bit for
  bit (the song, poly_echo at 16 voices), and counts one cut a program a
  chunk ("slice.windows").
"""

import numpy as np
import pytest
import torch

from zang_tpu_torch import trace
from zang_tpu_torch.device import arrays_to_device, to_device
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import song as tsong
from zang_tpu_torch.ops.segprog import SegProgram, WindowPlan, chunkify_tiled, plan_windows
from zang_tpu_torch.ops.tile_windows import SegTable, tile_windows, tile_windows_ref
from zang_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

TOCCATA_TOTAL = int(tsong.NUM_SECONDS * tsong.SAMPLE_RATE)


def _table(sp: SegProgram) -> SegTable:
    tables = trender._upload_tables([sp], "cpu")
    return tables[0]


def _assert_cut_is_chunkify_tiled(sp, chunk, total, tile=512):
    """Every chunk's cut against chunkify_tiled; the plan's S against its."""
    n_chunks = -(-total // chunk)
    want = chunkify_tiled(sp, chunk, n_chunks, total, tile)
    plan = plan_windows(sp, chunk, n_chunks, total, tile)
    assert plan.S == want["tb"].shape[-1]
    assert plan.nt == chunk // tile and plan.total == total
    table = _table(sp)
    for i in range(n_chunks):
        got = tile_windows_ref(table, plan, i * chunk)
        assert got.keys() == want.keys()
        for name, arr in want.items():
            w = to_device(arr[i], "cpu")
            g = got[name]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, i)
            assert torch.equal(g, w), (name, i)


def _programs(perf):
    return tree_leaves(perf.programs, SegProgram)


@pytest.fixture(scope="module")
def toccata_programs():
    return _programs(tsong.build_performance(TOCCATA_TOTAL))


@pytest.fixture(scope="module")
def texture():
    perf, total = tconfigs.build_poly_echo_performance(num_voices=256, seconds=3.0)
    return _programs(perf), total


@pytest.mark.parametrize("chunk", [65536, 8192])
def test_cut_is_chunkify_tiled_on_the_toccata(toccata_programs, chunk):
    assert [p.starts.shape[0] for p in toccata_programs] == [3, 3, 14, 14]
    for sp in toccata_programs:
        _assert_cut_is_chunkify_tiled(sp, chunk, TOCCATA_TOTAL)


@pytest.mark.parametrize("chunk", [65536, 8192])
def test_cut_is_chunkify_tiled_on_a_texture(texture, chunk):
    programs, total = texture
    assert len(programs) == 2 and all(p.starts.shape[0] == 256 for p in programs)
    for sp in programs:
        _assert_cut_is_chunkify_tiled(sp, chunk, total)


def _edge_program(seed, V=7, K=9, total=5000, tile=512):
    """Sorted starts per voice that hit the edges, and values of the dtypes
    the planners use (f32, int32, u32)."""
    rng = np.random.default_rng(seed)
    starts = np.empty((V, K), np.int64)
    for v in range(V):
        pool = np.concatenate([
            rng.integers(0, total + 2 * tile, K),                    # anywhere, past total too
            rng.integers(0, (total + tile) // tile, K) * tile,     # on tile boundaries
            [total, total - 1, total + 1, 0, 1, tile - 1, tile],
        ])
        starts[v] = np.sort(rng.choice(pool, K))
    starts[0] = [0] + [total] * (K - 1)          # one segment, the rest padding
    starts[1] = np.sort(rng.integers(tile + 3, total, K))  # the first start after 0
    starts[2] = [-700, -3] + sorted(rng.integers(0, total, K - 2))  # before 0
    starts[3, 2:5] = starts[3, 2]                # repeated starts
    starts[4] = total + np.arange(K)             # every start at or past total
    values = {"f": rng.standard_normal((V, K)).astype(np.float32),
              "i": rng.integers(-9, 9, (V, K)).astype(np.int32),
              "u": rng.integers(0, 2 ** 32, (V, K), dtype=np.uint64).astype(np.uint32)}
    return SegProgram(starts=starts, values=values)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("chunk,total", [(1024, 5000), (2048, 5000), (512, 4096), (1536, 5121)])
def test_cut_is_chunkify_tiled_at_the_edges(seed, chunk, total):
    _assert_cut_is_chunkify_tiled(_edge_program(seed, total=total), chunk, total)


def test_plan_counts_slots_in_one_pass_of_the_starts():
    """S from the starts alone: two starts strictly inside one tile of a
    covered voice make 3 slots; starts at or past total add none; repeated
    starts each take a slot; a start on the boundary adds none."""
    starts = np.array([[0, 100, 200, 512, 2000, 2000, 2001],
                       [0, 1024, 1030, 1500, 4000, 4001, 4002]], np.int64)
    sp = SegProgram(starts=starts, values={"x": np.zeros(starts.shape, np.float32)})
    for n_chunks, total, S in ((2, 2000, 3), (4, 4000, 4), (4, 4001, 4)):
        assert plan_windows(sp, 1024, n_chunks, total).S == S
        assert chunkify_tiled(sp, 1024, n_chunks, total)["tb"].shape[-1] == S
    starts[:, :4] = [0, 512, 1024, 1536]  # every start before total on a boundary
    assert plan_windows(sp, 1024, 2, 2000).S == 1
    assert chunkify_tiled(sp, 1024, 2, 2000)["tb"].shape[-1] == 1


def _step_with(perf, chunk, slices):
    """The eager step on the CPU fed `slices` chunk by chunk."""
    step = trender.make_stream_step(perf, chunk, device="cpu")
    xs, n_chunks = slices
    state, out = None, []
    for i in range(n_chunks):
        state, audio = step(state, i * chunk, trender.chunk_slice(xs, i))
        out.append(audio)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("name", ["song", "poly_echo_16"])
def test_render_through_the_plans_is_the_host_sliced_render(name):
    if name == "song":
        total, chunk = 2 * 48000 + 123, 8192
        perf = tsong.build_performance(total)
    else:
        perf, total = tconfigs.build_poly_echo_performance(num_voices=16, seconds=1.0)
        chunk = 16384
    n_chunks = -(-total // chunk)
    n_progs = len(_programs(perf))
    before = trace.counters().get("slice.windows", 0)
    got = trender.render_performance(perf, total, chunk, device="cpu")
    assert trace.counters()["slice.windows"] - before == n_chunks * n_progs
    want = _step_with(perf, chunk, trender.host_slices(perf, total, chunk))[:, :total]
    assert trace.counters()["slice.windows"] - before == n_chunks * n_progs
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want) and want.abs().max() > 1e-3


def test_the_router_counts_a_cut_and_takes_the_plain_version_on_the_cpu():
    sp = _edge_program(3)
    plan = plan_windows(sp, 1024, 5, 5000)
    table = _table(sp)
    before = trace.counters().get("slice.windows", 0)
    got = tile_windows(table, plan, 2048)
    assert trace.counters()["slice.windows"] - before == 1
    want = tile_windows_ref(table, plan, 2048)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_a_shared_step_refuses_window_plans():
    """A step called with another song's programs (serve/batch.py) takes
    host slices: window plans would be cut from its own tables."""
    perf = tsong.build_performance(48000)
    step = trender.make_stream_step(perf, 8192, device="cpu")
    static = arrays_to_device(perf.programs, "cpu")
    xs, _ = perf.chunk_xs(48000, 8192)
    assert tree_leaves(xs, WindowPlan)
    with pytest.raises(ValueError, match="host_slices"):
        step(None, 0, trender.chunk_slice(xs, 0), static)
    sl, _ = trender.host_slices(perf, 48000, 8192)
    _, audio = step(None, 0, trender.chunk_slice(sl, 0), static)
    assert audio.shape == (1, 8192)
