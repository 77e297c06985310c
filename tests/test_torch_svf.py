"""The port's table-cut SVF (zang_tpu_torch/ops/filters.py, svf_cuda.py)
against zang_tpu's.

The plain torch version is held to the JAX package's CPU fallback and to
its Pallas kernel in interpret mode, with the bounds of
tests/test_ops_effects.py: rms < -120 dBFS, end states within 1e-5. The
CUDA kernel is held to the plain version on the card (marker `cuda`,
skipped without one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.ops import filters as jfilt
from zang_tpu.ops.pallas_svf import svf_filter_pallas_table
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
