"""The one-pass table-cut SVF (K3) and the voice-grouped render that feeds
it, against zang_tpu's.

svf_onepass_table_ref, the plain version of the one-pass CUDA kernel
(zang_tpu_torch/csrc/svf_onepass.cu), is the sequential recurrence as a
loop over samples. It is held to the JAX package's one-pass Pallas kernel
in interpret mode at that kernel's own test case (tests/test_ops_effects.py
TestPallasSVFOnepass: V = 4096, n = 2048, active_from inside the chunk;
rms < -120 dBFS, end states within 1e-5) and to the affine-scan filter
(< -110 dBFS, that test's bound). The kernel itself is held to the loop on
the card in tests/test_torch_cuda_kernels.py (marker `cuda`).

NiceInstrument renders large voice counts by groups of voices into one
buffer that a single filter call takes whole: a forced small group gives
the bits of the ungrouped render.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_cuda_kernels import ONEPASS_EDGES, onepass_edge_args, onepass_edge_case
from zang_tpu.ops import filters as jfilt
from zang_tpu.ops.pallas_svf import ONEPASS_V_MIN, svf_onepass_table
from zang_tpu_torch.graph.render import render_performance
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import examples as tex
from zang_tpu_torch.host import instruments as tti
from zang_tpu_torch.ops import filters as tfilt
from zang_tpu_torch.ops import svf_cuda
from zang_tpu_torch.trace import launch_counts

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

TYPES = ["low_pass", "band_pass", "high_pass", "notch", "all_pass"]


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


def _case(seed, V, n, nt, S, t0):
    """Tables in the tiled format (slot 0 at the tile start, sorted
    boundaries inside the tile), active_from inside the chunk."""
    rng = np.random.default_rng(seed)
    T = n // nt
    tb = np.empty((V, nt, S), np.int32)
    tb[:, :, 0] = -(2 ** 31)
    tb[:, :, 1:] = (np.sort(rng.integers(0, T, (V, nt, S - 1)), axis=-1)
                    + t0 + np.arange(nt)[None, :, None] * T)
    return dict(
        tb=tb, cutv=rng.uniform(0.05, 0.9, (V, nt, S)).astype(np.float32),
        af=rng.integers(t0, t0 + n // 2, V).astype(np.int32),
        x=(rng.standard_normal((V, n)) * 0.3).astype(np.float32),
        l0=(rng.standard_normal(V) * 0.1).astype(np.float32),
        b0=(rng.standard_normal(V) * 0.1).astype(np.float32), t0=t0)


def _args(c, ftype, xp=torch.from_numpy, res=0.3):
    return (xp(c["l0"]), xp(c["b0"]), xp(c["x"]), ftype, xp(c["tb"]), xp(c["cutv"]), res,
            c["t0"], xp(c["af"]))


@pytest.fixture(scope="module")
def big():
    return _case(7, ONEPASS_V_MIN, 2048, 128, 3, 512)


@pytest.fixture(scope="module")
def big_loop(big):
    return tfilt.svf_onepass_table_ref(*_args(big, "low_pass"))


def test_threshold_is_the_jax_packages():
    assert tfilt.ONEPASS_V_MIN == ONEPASS_V_MIN == 4096


def test_loop_matches_onepass_pallas_interpret(big, big_loop):
    """The loop against the TPU kernel in interpret mode. Both are the
    sequential recurrence; XLA's CPU code may contract a multiply-add where
    torch rounds twice, so this holds the JAX test's bounds and reports the
    share of samples that are not bit-equal."""
    lj, bj, oj = svf_onepass_table(*_args(big, "low_pass", jnp.asarray), interpret=True)
    lt, bt, ot = big_loop
    assert _rms_db(ot.numpy(), oj) < -120.0
    assert np.abs(lt.numpy() - np.asarray(lj)).max() < 1e-5
    assert np.abs(bt.numpy() - np.asarray(bj)).max() < 1e-5
    differ = float((ot.numpy() != np.asarray(oj)).mean())
    print(f"one-pass loop vs Pallas interpret: {differ:.2%} of the samples differ, "
          f"rms {_rms_db(ot.numpy(), oj):.1f} dBFS")
    act = (big["t0"] + np.arange(big["x"].shape[1]))[None, :] >= big["af"][:, None]
    assert (ot.numpy()[~act] == 0.0).all() and np.abs(ot.numpy()[act]).max() > 0.05


def test_loop_matches_affine_scan_filter(big, big_loop):
    lr, br, orf = tfilt.svf_filter_table_ref(*_args(big, "low_pass"))
    lt, bt, ot = big_loop
    assert _rms_db(ot.numpy(), orf.numpy()) < -110.0
    assert (lt - lr).abs().max() < 1e-5 and (bt - br).abs().max() < 1e-5


@pytest.mark.parametrize("ftype", TYPES)
def test_loop_matches_table_ref_every_filter_type(ftype):
    """A ragged shape (tiles of 50 frames, 6 slots), every output mix."""
    c = _case(8, 5, 400, 8, 6, 4096)
    got = tfilt.svf_onepass_table_ref(*_args(c, ftype))
    want = tfilt.svf_filter_table_ref(*_args(c, ftype))
    assert _rms_db(got[2].numpy(), want[2].numpy()) < -120.0
    assert (got[0] - want[0]).abs().max() < 1e-5 and (got[1] - want[1]).abs().max() < 1e-5


def test_loop_without_active_from_and_chained():
    """No active_from: always active. Two chained calls over halves are the
    bits of one call over the whole (no seams to differ at)."""
    c = _case(9, 4, 1024, 8, 3, 2048)
    a = list(_args(c, "low_pass"))
    a[8] = None
    l_full, b_full, full = tfilt.svf_onepass_table_ref(*a)
    n, nt = 512, 4
    l, b, halves = a[0], a[1], []
    for k in range(2):
        l, b, out = tfilt.svf_onepass_table_ref(
            l, b, a[2][:, k * n:(k + 1) * n].contiguous(), "low_pass",
            a[4][:, k * nt:(k + 1) * nt].contiguous(),
            a[5][:, k * nt:(k + 1) * nt].contiguous(), 0.3, c["t0"] + k * n, None)
        halves.append(out)
    assert torch.equal(torch.cat(halves, dim=1), full)
    assert torch.equal(l, l_full) and torch.equal(b, b_full)


@pytest.mark.parametrize("name", list(ONEPASS_EDGES))
def test_loop_matches_jax_table_filter_at_kernel_batch_edges(name):
    """The cases that the card tests hold K3 to the loop with
    (tests/test_torch_cuda_kernels.py ONEPASS_EDGES: active_from and slot
    boundaries inside and on K3's 32-sample batches, unsorted slots, time
    tiles that end inside a batch, 1-4 slots, ragged V and n): the loop
    against the JAX package's svf_filter_table on the CPU (the table
    evaluated, then its affine scan), within the affine-scan bounds above;
    inactive samples are zeros in both."""
    c = onepass_edge_case(name)
    lt, bt, ot = tfilt.svf_onepass_table_ref(*onepass_edge_args(c, "cpu"))
    jx = lambda a: None if a is None else jnp.asarray(a)
    lj, bj, oj = jfilt.svf_filter_table(jx(c["l0"]), jx(c["b0"]), jx(c["x"]), "low_pass",
                                        jx(c["tb"]), jx(c["cutv"]), 0.3, c["t0"], jx(c["af"]))
    assert _rms_db(ot.numpy(), oj) < -110.0
    assert np.abs(lt.numpy() - np.asarray(lj)).max() < 1e-5
    assert np.abs(bt.numpy() - np.asarray(bj)).max() < 1e-5
    if c["af"] is not None:
        act = (c["t0"] + np.arange(c["x"].shape[1]))[None, :] >= c["af"][:, None]
        assert (ot.numpy()[~act] == 0.0).all() and (np.asarray(oj)[~act] == 0.0).all()
    assert np.abs(ot.numpy()).max() > 0.05


def test_router_takes_plain_on_cpu_at_large_v(monkeypatch, big):
    """No switch and no fallback: a CPU x goes to svf_filter_table_ref at
    any V; neither kernel's wrapper is reached."""
    def no_kernel(*a, **k):
        raise AssertionError("a CUDA wrapper was reached from a CPU tensor")

    monkeypatch.setattr(svf_cuda, "svf_onepass_cuda", no_kernel)
    monkeypatch.setattr(svf_cuda, "svf_table_cuda", no_kernel)
    before = launch_counts()["svf_onepass"]
    small = {k: (v[:, :256] if k == "x" else v[:, :16] if k in ("tb", "cutv") else v)
             for k, v in big.items()}
    small = {k: np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v
             for k, v in small.items()}
    args = _args(small, "low_pass")
    assert args[2].shape[0] >= tfilt.ONEPASS_V_MIN
    got, want = tfilt.svf_filter_table(*args), tfilt.svf_filter_table_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch_counts()["svf_onepass"] == before


def test_router_donated_x_gives_the_same_result():
    """donate_x lets the one-pass kernel write over x; the plain path a CPU
    tensor takes returns its own tensor, leaves x alone and gives the same
    bits."""
    c = _case(10, 3, 512, 4, 3, 1024)
    args = _args(c, "low_pass")
    want = tfilt.svf_filter_table(*args)
    x = args[2].clone()
    got = tfilt.svf_filter_table(*args[:2], x, *args[3:], donate_x=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(x, args[2])


# (V, S) -> the kernel svf_filter_table launches for a CUDA x: the one-pass
# kernel keeps a tile's slots in registers (at most 4); the table-cut kernel
# takes any S at any V, as the JAX package's table path does
ROUTES = {
    (ONEPASS_V_MIN, 1): "onepass", (ONEPASS_V_MIN, 2): "onepass",
    (16384, 4): "onepass", (ONEPASS_V_MIN, 5): "table", (16384, 9): "table",
    (ONEPASS_V_MIN - 1, 2): "table", (14, 5): "table", (1, 1): "table",
}


@pytest.mark.parametrize("shape", list(ROUTES), ids=lambda s: "V{}xS{}".format(*s))
def test_router_route(shape):
    assert tfilt.svf_table_route(*shape) == ROUTES[shape]


@pytest.mark.parametrize("S", [4, 5])
def test_router_sends_cuda_x_where_the_route_says(monkeypatch, S):
    """svf_filter_table on a tensor that reports a CUDA device reaches the
    wrapper the route names and no other; donate_x reaches only K3."""
    seen = []

    def wrapper(name):
        def call(*args, **kw):
            seen.append((name, kw.get("out") is not None))
            return args[0], args[1], args[2]
        return call

    class CudaX(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    monkeypatch.setattr(svf_cuda, "svf_onepass_cuda", wrapper("onepass"))
    monkeypatch.setattr(svf_cuda, "svf_table_cuda", wrapper("table"))
    c = _case(14, ONEPASS_V_MIN, 16, 1, S, 0)
    args = list(_args(c, "low_pass"))
    args[2] = args[2].as_subclass(CudaX)
    tfilt.svf_filter_table(*args, donate_x=True)
    assert seen == [("onepass", True)] if S <= tfilt.ONEPASS_MAX_SLOTS else \
        seen == [("table", False)]


def test_onepass_wrapper_raises_on_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        svf_cuda.svf_onepass_cuda(*_args(_case(11, 2, 256, 2, 2, 0), "low_pass"))


@pytest.mark.parametrize("shape, why", [((2, 1002, 6, 3), "multiple of 4"),
                                        ((2, 1024, 8, 5), "at most 4 slots")])
def test_onepass_wrapper_refuses_what_it_is_not_built_for(shape, why):
    """The kernel copies 16 bytes a lane and keeps a tile's slots in
    registers: another n or more slots raise (svf_table_cuda takes them)."""
    with pytest.raises(ValueError, match=why):
        svf_cuda.svf_onepass_cuda(*_args(_case(13, *shape, 0), "low_pass"))


def test_onepass_wrapper_refuses_out_that_overlaps_x():
    """out is x itself or apart from it: a shifted view of x's storage would
    be overwritten before it is read."""
    c = _case(14, 4, 256, 2, 2, 0)
    args = _args(c, "low_pass")
    store = torch.zeros((5, 256))
    x, out = store[:4], store[1:]
    x.copy_(args[2])
    with pytest.raises(ValueError, match="overlaps"):
        svf_cuda.svf_onepass_cuda(*args[:2], x, *args[3:], out=out)


# ---------------------------------------------------------------------------
# the voice-grouped render


@pytest.mark.parametrize("group_voices", [1, 3, 4])
def test_grouped_render_is_the_ungrouped_bits(monkeypatch, group_voices):
    """poly_echo at 7 voices: groups of 1, 3 (a ragged last group) and 4."""
    chunk = 16384
    perf, total = tconfigs.build_poly_echo_performance(num_voices=7, seconds=1.0, seed=3)
    want = render_performance(perf, total, chunk, device="cpu")
    assert 7 <= tti.GROUP_VOICE_SAMPLES // chunk  # ungrouped as the code stands
    monkeypatch.setattr(tti, "GROUP_VOICE_SAMPLES", group_voices * chunk)
    got = render_performance(perf, total, chunk, device="cpu")
    assert torch.equal(got, want) and float(want.abs().max()) > 0.05


def test_grouped_render_per_voice_color(monkeypatch):
    """The song's organ part has a per-voice color array: grouped by two
    voices it renders the same bits."""
    from zang_tpu_torch.core.notes import SongEvent
    from zang_tpu_torch.core.timeline import compile_timelines
    from zang_tpu_torch.graph.render import Performance

    sr, total = 48000.0, 16384
    song = [SongEvent({"freq": 220.0 * (i + 1), "note_on": True}, t=0.01 * i, note_id=i + 1)
            for i in range(5)]
    tls = compile_timelines(song, 5, sr, total)
    perf = Performance([(tti.NiceInstrument(np.linspace(0.1, 0.5, 5)), tls)], sr)
    want = render_performance(perf, total, 8192, device="cpu")
    monkeypatch.setattr(tti, "GROUP_VOICE_SAMPLES", 2 * 8192)
    assert torch.equal(render_performance(perf, total, 8192, device="cpu"), want)
    assert float(want.abs().max()) > 0.05


def test_polyphony_example_keeps_its_bits_when_grouped(monkeypatch):
    """DecimatedNice inherits the grouped render."""
    want, _ = tex.ex_polyphony(seconds=2.0, device="cpu")
    monkeypatch.setattr(tti, "GROUP_VOICE_SAMPLES", 16 * tex.DEFAULT_CHUNK)
    got, _ = tex.ex_polyphony(seconds=2.0, device="cpu")
    assert torch.equal(got, want) and float(want.abs().max()) > 0.01


def test_group_size_fits_the_card():
    """The budget: a group's transients (~6 MiB a voice at 65536 frames)
    plus the 16384-voice buffer stay well under an 80 GB card, and the
    1024-voice config is one group."""
    group = tti.GROUP_VOICE_SAMPLES // 65536
    assert 1024 <= group <= 4096
    assert group * 6 * 2 ** 20 + 16384 * 65536 * 4 < 32 * 2 ** 30
