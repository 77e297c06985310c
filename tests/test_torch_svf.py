"""The port's SVF filters (zang_tpu_torch/ops/filters.py, svf_cuda.py)
against zang_tpu's: the table-cut filter (K1) and the dense-cut one (K2).
K1's launch geometry, its seams composed in torch (svf_table_emulated) and
its slot walk are checked here too, since its CUDA body runs only on the
card.

The plain torch versions are held to the JAX package's CPU fallback and to
its Pallas kernels in interpret mode, with the bounds of
tests/test_ops_effects.py: rms < -120 dBFS, end states within 1e-5. The
CUDA kernels are held to the plain versions on the card in
tests/test_torch_cuda_kernels.py, which imports no JAX (marker `cuda`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.ops import filters as jfilt
from zang_tpu.ops.pallas_svf import GATE_V_MIN, svf_filter_pallas, svf_filter_pallas_table
from zang_tpu_torch.core import twelve_tet
from zang_tpu_torch.ops import _build, svf_cuda
from zang_tpu_torch.ops import filters as tfilt
from zang_tpu_torch.trace import launch_counts

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

TYPES = ["low_pass", "band_pass", "high_pass", "notch", "all_pass"]


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


def _case(seed, V=6, nt=128, T=16, S=3, t0=4096):
    rng = np.random.default_rng(seed)
    n = nt * T
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


def _torch_args(c, ftype, device="cpu"):
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(c["l0"]), to(c["b0"]), to(c["x"]), ftype, to(c["tb"]), to(c["cutv"]),
            0.3, c["t0"], to(c["af"]))


def _jax_args(c, ftype):
    return (jnp.asarray(c["l0"]), jnp.asarray(c["b0"]), jnp.asarray(c["x"]), ftype,
            jnp.asarray(c["tb"]), jnp.asarray(c["cutv"]), 0.3, c["t0"],
            jnp.asarray(c["af"]))


def _assert_close(got, ref):
    lt, bt, ot = (np.asarray(v) for v in got)
    lr, br, orf = (np.asarray(v) for v in ref)
    assert _rms_db(ot, orf) < -120.0
    assert np.abs(lt - lr).max() < 1e-5 and np.abs(bt - br).max() < 1e-5


@pytest.mark.parametrize("ftype", TYPES)
def test_plain_matches_jax_fallback(ftype):
    c = _case(0)
    _assert_close(tfilt.svf_filter_table(*_torch_args(c, ftype)),
                  jfilt.svf_filter_table(*_jax_args(c, ftype)))


@pytest.mark.parametrize("ftype", TYPES)
def test_plain_matches_pallas_interpret(ftype):
    c = _case(1)
    _assert_close(tfilt.svf_filter_table(*_torch_args(c, ftype)),
                  svf_filter_pallas_table(*_jax_args(c, ftype), interpret=True))


def test_plain_state_chains_across_calls():
    """Two chained calls over halves == one call over the whole."""
    c = _case(2, V=3, nt=8, T=256, S=3, t0=1024)
    n, nt = c["x"].shape[1] // 2, 4
    l_full, b_full, full = tfilt.svf_filter_table(*_torch_args(c, "low_pass"))
    l, b = torch.from_numpy(c["l0"]), torch.from_numpy(c["b0"])
    halves = []
    for k in range(2):
        l, b, out = tfilt.svf_filter_table(
            l, b, torch.from_numpy(c["x"][:, k * n:(k + 1) * n].copy()), "low_pass",
            torch.from_numpy(c["tb"][:, k * nt:(k + 1) * nt].copy()),
            torch.from_numpy(c["cutv"][:, k * nt:(k + 1) * nt].copy()), 0.3,
            c["t0"] + k * n, torch.from_numpy(c["af"]))
        halves.append(out)
    _assert_close((l, b, torch.cat(halves, dim=1)), (l_full, b_full, full))


def test_plain_matches_sequential_recurrence():
    """svf_filter against the per-sample recurrence in f32, one step at a
    time (the reference's own loop)."""
    rng = np.random.default_rng(3)
    V, n = 3, 700
    x = (rng.standard_normal((V, n)) * 0.3).astype(np.float32)
    cut = rng.uniform(0.05, 0.6, (V, n)).astype(np.float32)
    act = rng.uniform(size=(V, n)) > 0.1
    l0 = np.zeros(V, np.float32)
    lt, bt, ot = tfilt.svf_filter(torch.from_numpy(l0), torch.from_numpy(l0),
                                  torch.from_numpy(x), "notch", torch.from_numpy(cut),
                                  0.3, torch.from_numpy(act))
    l = torch.zeros(V)
    b = torch.zeros(V)
    out = np.zeros((V, n), np.float32)
    r = torch.tensor(np.float32(1.0) - np.float32(0.3))
    for i in range(n):
        la, ba, h = tfilt._svf_step(l, b, torch.from_numpy(x[:, i]),
                                    torch.from_numpy(cut[:, i]), r)
        m = torch.from_numpy(act[:, i])
        out[:, i] = torch.where(m, la + h, 0.0).numpy()
        l, b = torch.where(m, la, l), torch.where(m, ba, b)
    assert _rms_db(ot.numpy(), out) < -120.0
    assert (l - lt).abs().max() < 1e-5 and (b - bt).abs().max() < 1e-5


@pytest.mark.parametrize("sr", [44100.0, 48000.0])
def test_cutoff_from_frequency_matches_jax(sr):
    """cutoff_from_frequency over 4000 frequencies of the audio band (a log
    sweep and uniform draws) against the JAX package's: fewer than 1% not
    bit-equal, and each of those is the cutoff of a cos one ulp away from
    the port's (the two cos differ in the last place; sqrt(2 (1 - cos))
    magnifies that at low frequencies)."""
    f = np.float32
    rng = np.random.default_rng(14)
    freqs = np.concatenate([np.geomspace(10.0, 22000.0, 2000),
                            rng.uniform(20.0, 20000.0, 2000)]).astype(f)
    want = np.asarray(jfilt.cutoff_from_frequency(jnp.asarray(freqs), sr))
    got = np.array([tfilt.cutoff_from_frequency(v, sr) for v in freqs], f)
    assert got.dtype == want.dtype == f
    differ = got != want
    assert differ.sum() < freqs.size // 100, f"{differ.sum()} of {freqs.size} differ"
    for v, w in zip(freqs[differ], want[differ]):
        c = f(np.cos(np.float64(f(f(np.pi) * v / f(sr)))))
        near = [np.sqrt(np.clip(f(2.0) * (f(1.0) - np.nextafter(c, f(d))), f(0.0),
                                f(1.0)), dtype=f) for d in (-2.0, 2.0)]
        assert w in near, f"{v} Hz: {w!r} is not the cutoff of a neighbouring cos"


def test_wrapper_raises_on_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        svf_cuda.svf_table_cuda(*_torch_args(_case(4), "low_pass"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    access = _build.os.access  # no nvcc anywhere, even on a machine with one
    monkeypatch.setattr(_build.os, "access",
                        lambda p, mode: not str(p).endswith("nvcc") and access(p, mode))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("svf_table")
    assert not (tmp_path / "build").exists()


# ---------------------------------------------------------------------------
# K1's design: geometry, seams and slot walk


# (V, n, nt) -> (W, cluster, rounds): every shape the port sends K1 (the
# song, poly_echo at 1024 voices, the polyphony examples, the chained and
# ragged cases, the test shapes), K1 called by name beside K3, and chunks
# that render_song and render_wav --chunk take (any multiple of 512)
GEOMETRY = {
    (14, 65536, 128): (8192, 8, 1),     # the song
    (1024, 65536, 128): (8192, 8, 1),   # poly_echo at 1024 voices
    (16384, 65536, 128): (8192, 8, 1),  # K1 by name at the capacity size
    (39, 16384, 32): (8192, 2, 1),      # polyphony
    (3, 16384, 32): (8192, 2, 1),       # polyphony2
    (4096, 16384, 32): (8192, 2, 1),    # beside K3
    (4, 4096, 8): (4096, 1, 1),         # a chained half
    (3, 2048, 4): (2048, 1, 1),         # ragged
    (6, 2048, 128): (2048, 1, 1),       # 16-frame tiles
    (2, 12288, 24): (6144, 2, 1),       # a window that is not 8192
    (2, 17920, 35): (4480, 4, 1),       # 35 tiles of 512: 3 windows do not cut it
    (3, 8208, 8): (2736, 3, 1),         # a multiple of 16 only
    (2, 131072, 256): (16384, 8, 1),    # the most one round takes
    (14, 262144, 512): (16384, 8, 2),   # render_wav song --chunk 262144
    (1, 393216, 768): (16384, 8, 3),
    (1, 16 * 4099, 1): (16, 1, 4099),   # a prime count of runs: one run a window
}


@pytest.mark.parametrize("shape", list(GEOMETRY), ids=lambda s: "x".join(map(str, s)))
def test_k1_geometry(shape):
    V, n, nt = shape
    g = svf_cuda.svf_table_geometry(V, n, nt, 3)
    assert (g.window, g.cluster, g.rounds) == GEOMETRY[shape]
    assert g.run == 16 and g.window * g.cluster * g.rounds == n and g.window % g.run == 0
    assert 1 <= g.cluster <= 8 and g.window <= 16384
    assert g.threads % 32 == 0 and g.threads - 32 < g.window // g.run <= g.threads <= 1024
    tile = n // nt
    assert g.tiles >= max(((w + 1) * g.window - 1) // tile - w * g.window // tile + 1
                          for w in range(g.cluster * g.rounds))
    assert g.shared == 4 * 20 * (g.window // 16) + 8 * g.tiles * 3 <= 227 * 1024


def test_k1_geometry_takes_every_render_chunk():
    """Every chunk size that the renderers accept (a multiple of 512, here
    up to 307,200 frames), in the song's 512-frame tiles."""
    for n in range(512, 600 * 512 + 1, 512):
        g = svf_cuda.svf_table_geometry(14, n, n // 512, 2)
        assert g.window * g.cluster * g.rounds == n and g.window % 16 == 0, n


@pytest.mark.parametrize("shape, match", [
    ((3, 1000, 8), "multiple of 16"),        # runs do not tile the chunk
    ((3, 8200, 8), "multiple of 16"),
    ((3, 2048, 5), "does not split"),        # n % nt
    ((3, 65536, 65536, 4), "shared memory"),  # tables too large to stage
    ((0, 2048, 4), "V, n, nt, S >= 1"),
])
def test_k1_geometry_raises(shape, match):
    V, n, nt, *S = shape
    with pytest.raises(ValueError, match=match):
        svf_cuda.svf_table_geometry(V, n, nt, S[0] if S else 3)


@pytest.mark.parametrize("case", [
    dict(V=3, nt=128, T=512, S=2, t0=7 * 65536),   # the song's chunk, 3 voices
    dict(V=5, nt=32, T=512, S=3, t0=3 * 16384),    # polyphony's chunk
    dict(V=3, nt=4, T=512, S=3, t0=4096),          # ragged
    dict(V=2, nt=128, T=16, S=3, t0=100),          # 16-frame tiles
    dict(V=2, nt=512, T=24, S=5, t0=0),            # tiles that runs straddle
    dict(V=2, nt=35, T=512, S=3, t0=65536),        # four windows of 4480 frames
    dict(V=2, nt=512, T=512, S=2, t0=0),           # two rounds of the cluster
], ids=["song", "polyphony", "ragged", "tile16", "tile24", "windows4480", "rounds2"])
def test_k1_emulation_matches_plain(case):
    """K1's seams (runs of 16 frames, warps, windows, the cluster's order)
    composed in torch hold to svf_filter_table_ref within the bounds the
    kernel is held to on the card."""
    c = _case(12, **case)
    args = _torch_args(c, "low_pass")
    _assert_close(svf_cuda.svf_table_emulated(*args), tfilt.svf_filter_table_ref(*args))


def _slot_walk(tb, cv, n, t0, window):
    """The cutoffs K1's threads read, in plain Python as csrc/svf_table.cu
    walks them: a window's tables staged with the boundaries as suffix
    minima, each run's slot found once and moved forward at a boundary or a
    tile edge."""
    V, nt, S = tb.shape
    tile = n // nt
    out = np.empty((V, n), np.float32)
    for v in range(V):
        for lo in range(0, n, window):
            k0 = lo // tile
            rows = {}
            for k in range(k0, (lo + window - 1) // tile + 1):
                m, row = 2 ** 31 - 1, [0] * S
                for j in range(S - 1, 0, -1):
                    m = min(m, int(tb[v, k, j]))
                    row[j] = m
                row[0] = -(2 ** 31)
                rows[k] = row
            for f0 in range(lo, lo + window, 16):
                k, j = f0 // tile, 0
                edge = (k + 1) * tile
                nxt = rows[k][1] if S > 1 else 2 ** 31 - 1
                for f in range(f0, f0 + 16):
                    if f == edge:
                        k, j, edge = k + 1, 0, edge + tile
                        nxt = rows[k][1] if S > 1 else 2 ** 31 - 1
                    while t0 + f >= nxt:
                        j += 1
                        nxt = rows[k][j + 1] if j + 1 < S else 2 ** 31 - 1
                    out[v, f] = cv[v, k, j]
    return out


@pytest.mark.parametrize("T, S, window", [(24, 5, 384), (8, 3, 256), (512, 4, 2048),
                                          (48, 1, 768)])
def test_k1_slot_walk_is_the_table_rule(T, S, window):
    """The slot walk gives eval_tiled_chunk's cutoff on every sample, for
    tables whose slots are not in order and tiles that are not a multiple
    of the run (runs straddle tile edges)."""
    from zang_tpu_torch.ops.segprog import eval_tiled_chunk

    rng = np.random.default_rng(T * S)
    V, nt, t0 = 3, 2 * window // T, 5000
    n = nt * T
    tb = (rng.integers(-T, 2 * T, (V, nt, S)) + t0
          + np.arange(nt)[None, :, None] * T).astype(np.int32)
    tb[:, :, 0] = rng.integers(-(2 ** 31), 2 ** 31 - 1, (V, nt))  # never read
    cv = rng.uniform(0.05, 0.9, (V, nt, S)).astype(np.float32)
    want = eval_tiled_chunk({"tb": torch.from_numpy(tb), "cut": torch.from_numpy(cv)},
                            t0 + torch.arange(n, dtype=torch.int32))["cut"].numpy()
    np.testing.assert_array_equal(_slot_walk(tb, cv, n, t0, window), want)


# ---------------------------------------------------------------------------
# the dense-cut filter (K2)


def _dense_case(seed, V, n, dense=True, masked=True):
    rng = np.random.default_rng(seed)
    return dict(
        x=(rng.standard_normal((V, n)) * 0.3).astype(np.float32),
        cut=(rng.uniform(0.05, 0.6, (V, n)) if dense
             else rng.uniform(0.05, 0.6, (V, 1))).astype(np.float32),
        act=(rng.uniform(size=(V, n)) > 0.1) if masked else None,
        l0=(rng.standard_normal(V) * 0.1).astype(np.float32),
        b0=(rng.standard_normal(V) * 0.1).astype(np.float32))


def _dense_torch(c, ftype, device="cpu", res=0.3):
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return (to(c["l0"]), to(c["b0"]), to(c["x"]), ftype, to(c["cut"]), res,
            to(c["act"]))


# probing: padded V < GATE_V_MIN keeps a separate activity array; gated:
# padded V >= GATE_V_MIN folds activity into cut's sign (pallas_svf.py:556-569)
@pytest.mark.parametrize("ftype", TYPES)
@pytest.mark.parametrize("V", [3, GATE_V_MIN - 6], ids=["probing", "gated"])
def test_plain_matches_dense_pallas_interpret(V, ftype):
    c = _dense_case(6, V, 1024)
    j = svf_filter_pallas(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                            for a in (c["l0"], c["b0"], c["x"], ftype, c["cut"], 0.3,
                                      c["act"])), interpret=True)
    _assert_close(tfilt.svf_filter_ref(*_dense_torch(c, ftype)), j)


@pytest.mark.parametrize("form", ["scalar", "column"])
def test_broadcast_cut_matches_dense(form):
    """A scalar or [V, 1] cutoff (FilteredSawtooth's is a scalar) gives the
    bits of the same cutoff written out to [V, n]."""
    c = _dense_case(7, 4, 900, dense=False)
    cut = np.float32(0.3) if form == "scalar" else c["cut"]
    args = list(_dense_torch(c, "low_pass"))
    args[4] = float(cut) if form == "scalar" else torch.from_numpy(cut)
    got = tfilt.svf_filter(*args)
    args[4] = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(cut, c["x"].shape)))
    want = tfilt.svf_filter(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_matches_jax_scalar_cut_no_mask():
    """FilteredSawtooth's call shape (x [1, n], scalar cut and res) against
    the JAX package's svf_filter, with and without a mask."""
    c = _dense_case(8, 1, 4096, masked=False)
    for act in (None, np.random.default_rng(9).uniform(size=(1, 4096)) > 0.3):
        tl = tfilt.svf_filter(torch.from_numpy(c["l0"]), torch.from_numpy(c["b0"]),
                              torch.from_numpy(c["x"]), "low_pass", 0.2, 0.7,
                              None if act is None else torch.from_numpy(act))
        jl = jfilt.svf_filter(jnp.asarray(c["l0"]), jnp.asarray(c["b0"]),
                              jnp.asarray(c["x"]), "low_pass", jnp.float32(0.2), 0.7,
                              None if act is None else jnp.asarray(act))
        _assert_close(tl, jl)


def test_router_takes_plain_on_cpu(monkeypatch):
    """No switch: a CPU x [V, n] with a scalar res goes to svf_filter_ref,
    and the dense kernel's wrapper is never reached."""
    def no_kernel(*a, **k):
        raise AssertionError("the CUDA wrapper was reached from a CPU tensor")

    monkeypatch.setattr(svf_cuda, "svf_dense_cuda", no_kernel)
    before = launch_counts()["svf_dense"]
    args = _dense_torch(_dense_case(10, 3, 512), "band_pass")
    got, want = tfilt.svf_filter(*args), tfilt.svf_filter_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch_counts()["svf_dense"] == before


def test_table_ref_never_reaches_the_router(monkeypatch):
    """svf_filter_table_ref calls svf_filter_ref by name, so K1's plain
    comparison on the card launches no K2."""
    def no_router(*a, **k):
        raise AssertionError("svf_filter_table_ref reached the svf_filter router")

    monkeypatch.setattr(tfilt, "svf_filter", no_router)
    c = _case(11, V=2, nt=4, T=64)
    tfilt.svf_filter_table_ref(*_torch_args(c, "low_pass"))


# ---------------------------------------------------------------------------
# K2's design: geometry and seams (its body is K1's, csrc/svf_window.cuh)


# (V, n) -> (W, cluster, rounds): the examples' chunks (play, stereo, detuned:
# 16384), the card's cases (V=1024 x 65,536, the ragged ones) and chunks past
# one round and with no whole runs
DENSE_GEOMETRY = {
    (1, 16384): (8192, 2, 1),        # play
    (2, 16384): (8192, 2, 1),        # stereo, detuned
    (1024, 65536): (8192, 8, 1),     # the card's wide case
    (3, 1000): (1008, 1, 1),         # ragged: 62.5 runs
    (5, 777): (784, 1, 1),
    (2, 1): (16, 1, 1),
    (4, 8192): (8192, 1, 1),
    (1, 131072): (16384, 8, 1),      # the most one round takes
    (1, 200000): (12512, 8, 2),      # 13 windows' worth, walked in 2 rounds
    (1, 16 * 4099): (8208, 8, 1),    # K1 would take a window of 16 frames here
}


@pytest.mark.parametrize("shape", list(DENSE_GEOMETRY),
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_geometry(shape):
    V, n = shape
    g = svf_cuda.svf_dense_geometry(V, n)
    assert (g.window, g.cluster, g.rounds) == DENSE_GEOMETRY[shape]
    assert g.run == 16 and g.window % 16 == 0 and g.window <= 16384
    # the windows cover n, and the last round's first window starts inside it
    assert g.window * g.cluster * g.rounds >= n > g.window * g.cluster * (g.rounds - 1)
    assert 1 <= g.cluster <= 8
    assert g.threads % 32 == 0 and g.threads - 32 < g.window // 16 <= g.threads <= 1024
    for dense, mask in ((False, False), (True, True)):
        assert svf_cuda.svf_dense_shared(g, dense, mask) <= 227 * 1024


def test_k2_geometry_takes_every_n():
    for n in list(range(1, 2000)) + list(range(2000, 400000, 997)):
        g = svf_cuda.svf_dense_geometry(1, n)
        assert g.window * g.cluster * g.rounds >= n > g.window * (g.cluster * g.rounds - 1)
        assert svf_cuda.svf_dense_shared(g, True, True) <= 227 * 1024, n


@pytest.mark.parametrize("shape", [(0, 16), (2, 0)])
def test_k2_geometry_raises(shape):
    with pytest.raises(ValueError, match="V, n >= 1"):
        svf_cuda.svf_dense_geometry(*shape)


def _example_case(name, seed=20):
    """K2's arguments at an example's call: play (V=1, FilteredSawtooth: a
    scalar cutoff, resonance 0.7, the note mask), stereo (V=2, a [2, 1]
    cutoff, resonance 0.4, no mask), detuned's two calls (V=2: the 4 Hz
    warble lowpass, resonance 0, no mask; the 7040 Hz lowpass under the
    note mask), all at the examples' chunk of 16384, and a ragged chunk
    with a [V, 1] cutoff and a mask."""
    rng = np.random.default_rng(seed)
    V, n, cut, res, masked = {
        "play": (1, 16384, float(tfilt.cutoff_from_frequency(
            np.float32(440.0) * np.float32(twelve_tet.c5), 48000.0)), 0.7, True),
        "stereo": (2, 16384, "column", 0.4, False),
        "detuned warble": (2, 16384, float(tfilt.cutoff_from_frequency(4.0, 48000.0)),
                           0.0, False),
        "detuned voice": (2, 16384, float(tfilt.cutoff_from_frequency(7040.0, 48000.0)),
                          0.7, True),
        "ragged": (3, 1000, "column", 0.7, True),
        "dense ragged": (5, 777, "dense", 0.3, True),
    }[name]
    if cut == "column":
        cut = torch.from_numpy(rng.uniform(0.05, 0.6, (V, 1)).astype(np.float32))
    elif cut == "dense":
        cut = torch.from_numpy(rng.uniform(-0.1, 1.1, (V, n)).astype(np.float32))
    act = None
    if masked:  # notes that start and stop inside the chunk
        on = rng.integers(0, n // 2, V)[:, None] <= np.arange(n)[None, :]
        act = torch.from_numpy(on & (rng.uniform(size=(V, n)) > 0.05))
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return (t(rng.standard_normal(V) * 0.1), t(rng.standard_normal(V) * 0.1),
            t(rng.standard_normal((V, n)) * 0.3), "low_pass", cut, res, act)


EXAMPLE_CASES = ["play", "stereo", "detuned warble", "detuned voice", "ragged",
                 "dense ragged"]


@pytest.mark.parametrize("name", EXAMPLE_CASES)
def test_k2_emulation_matches_jax(name):
    """K2's seams composed in torch (svf_dense_emulated) against the JAX
    package's svf_filter on the CPU (its affine-scan path, as its own
    tests run it there) and against svf_filter_ref, at the examples' calls:
    rms < -120 dBFS, end states within 1e-5."""
    args = _example_case(name)
    got = svf_cuda.svf_dense_emulated(*args)
    j = jfilt.svf_filter(*(jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
                           for a in args))
    _assert_close(got, j)
    _assert_close(got, tfilt.svf_filter_ref(*args))


@pytest.mark.parametrize("form", ["scalar", "column", "dense", "row", "dense strided"])
@pytest.mark.parametrize("masked", ["mask", "mask column", "no mask"])
def test_k2_emulation_forms(form, masked):
    """Every cutoff and mask form K2 reads, at a chunk of two windows with a
    ragged end (n = 8200 + 7): the emulation within the bounds of
    svf_filter_ref, and a broadcast form the same bits as written out."""
    rng = np.random.default_rng(21)
    V, n = 3, 8207
    cut = {"scalar": 0.3,
           "column": torch.from_numpy(rng.uniform(0.05, 0.6, (V, 1)).astype(np.float32)),
           "dense": torch.from_numpy(rng.uniform(0.05, 0.6, (V, n)).astype(np.float32)),
           "row": torch.from_numpy(rng.uniform(0.05, 0.6, (n,)).astype(np.float32)),
           "dense strided": torch.from_numpy(
               rng.uniform(0.05, 0.6, (V, 2 * n)).astype(np.float32))[:, ::2]}[form]
    act = {"mask": torch.from_numpy(rng.uniform(size=(V, n)) > 0.1),
           "mask column": torch.tensor([[True], [False], [True]]),
           "no mask": None}[masked]
    x = torch.from_numpy((rng.standard_normal((V, n)) * 0.3).astype(np.float32))
    l0 = torch.from_numpy((rng.standard_normal(V) * 0.1).astype(np.float32))
    args = (l0, -l0, x, "band_pass", cut, 0.6, act)
    got = svf_cuda.svf_dense_emulated(*args)
    _assert_close(got, tfilt.svf_filter_ref(*args))
    if not isinstance(cut, float):
        full = cut.broadcast_to((V, n)).contiguous()
        written = svf_cuda.svf_dense_emulated(*args[:4], full, *args[5:])
        assert all(torch.equal(g, w) for g, w in zip(got, written))


@pytest.mark.parametrize("form", ["0-dim", "column", "row", "dense", "strided",
                                  "transposed", "n=1"])
def test_k2_reads_each_form_through_its_strides(form):
    """The forms K2's wrapper hands the kernel: a tensor broadcast to
    [V, n] and read at [v * sv + t * st] with st 0 or 1 gives the broadcast
    values (other strides are made contiguous first)."""
    rng = np.random.default_rng(22)
    V, n = (3, 1) if form == "n=1" else (3, 50)
    t = torch.from_numpy(rng.uniform(size={
        "0-dim": (), "column": (V, 1), "row": (n,), "dense": (V, n),
        "strided": (V, 2 * n), "transposed": (n, V), "n=1": (V, 1)}[form]).astype(np.float32))
    t = {"strided": lambda a: a[:, ::2], "transposed": lambda a: a.t()}.get(form,
                                                                           lambda a: a)(t)
    for a in (t, t > 0.5):
        view, sv, st = svf_cuda._along_time(a, V, n)
        assert st in (0, 1)
        flat = torch.as_strided(view, (view.untyped_storage().nbytes()
                                       // view.element_size(),), (1,), 0)
        got = torch.stack([torch.stack([flat[view.storage_offset() + v * sv + i * st]
                                        for i in range(n)]) for v in range(V)])
        assert torch.equal(got, a.broadcast_to((V, n)))


def test_dense_wrapper_raises_on_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        svf_cuda.svf_dense_cuda(*_dense_torch(_dense_case(12, 2, 256), "low_pass"))
