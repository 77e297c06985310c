"""The port's SVF filters (zang_tpu_torch/ops/filters.py, svf_cuda.py)
against zang_tpu's: the table-cut filter (K1) and the dense-cut one (K2).

The plain torch versions are held to the JAX package's CPU fallback and to
its Pallas kernels in interpret mode, with the bounds of
tests/test_ops_effects.py: rms < -120 dBFS, end states within 1e-5. The
CUDA kernels are held to the plain versions on the card (marker `cuda`,
skipped without one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.ops import filters as jfilt
from zang_tpu.ops.pallas_svf import GATE_V_MIN, svf_filter_pallas, svf_filter_pallas_table
from zang_tpu_torch.ops import _build, svf_cuda
from zang_tpu_torch.ops import filters as tfilt

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(14, 128, 512, 2), (3, 4, 512, 3), (6, 128, 16, 3)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    V, nt, T, S = shape
    c = _case(5, V=V, nt=nt, T=T, S=S, t0=7 * 65536)
    args = _torch_args(c, "low_pass", cuda_device)
    before = svf_cuda.svf_table_launches
    got = tfilt.svf_filter_table(*args)
    ref = tfilt.svf_filter_table_ref(*args)
    torch.cuda.synchronize()
    assert svf_cuda.svf_table_launches == before + 1
    _assert_close(tuple(v.cpu() for v in got), tuple(v.cpu() for v in ref))


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
    before = svf_cuda.svf_dense_launches
    args = _dense_torch(_dense_case(10, 3, 512), "band_pass")
    got, want = tfilt.svf_filter(*args), tfilt.svf_filter_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert svf_cuda.svf_dense_launches == before


def test_table_ref_never_reaches_the_router(monkeypatch):
    """svf_filter_table_ref calls svf_filter_ref by name, so K1's plain
    comparison on the card launches no K2."""
    def no_router(*a, **k):
        raise AssertionError("svf_filter_table_ref reached the svf_filter router")

    monkeypatch.setattr(tfilt, "svf_filter", no_router)
    c = _case(11, V=2, nt=4, T=64)
    tfilt.svf_filter_table_ref(*_torch_args(c, "low_pass"))


def test_dense_wrapper_raises_on_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        svf_cuda.svf_dense_cuda(*_dense_torch(_dense_case(12, 2, 256), "low_pass"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 16384, "scalar"), (3, 1000, "column"), (1024, 4096, "dense"), (5, 777, "dense")])
def test_dense_kernel_matches_plain_on_card(cuda_device, shape):
    V, n, form = shape
    c = _dense_case(13, V, n, dense=form == "dense")
    args = list(_dense_torch(c, "low_pass", cuda_device))
    if form == "scalar":
        args[4] = 0.2
    before = svf_cuda.svf_dense_launches
    got = tfilt.svf_filter(*args)
    ref = tfilt.svf_filter_ref(*args)
    torch.cuda.synchronize()
    assert svf_cuda.svf_dense_launches == before + 1
    _assert_close(tuple(v.cpu() for v in got), tuple(v.cpu() for v in ref))
