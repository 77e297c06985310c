"""zang_tpu_torch device ops against their zang_tpu (JAX) originals.

Same inputs, made with numpy seeds, go through both; JAX runs on the CPU.
Tolerances: u32 phase math and the tiled program evaluation are
bit-exact; sine within 1e-6 (XLA:CPU's and torch's sin differ by ulps);
pulse bit-exact off transition samples and within 4 ulp on them (f32
division rounds differently in the gain term); painter within 1 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.ops import control as jctl
from zang_tpu.ops import oscillators as josc
from zang_tpu.ops import scan as jscan
from zang_tpu.ops import segprog as jseg
from zang_tpu_torch.ops import control as tctl
from zang_tpu_torch.ops import oscillators as tosc
from zang_tpu_torch.ops import scan as tscan
from zang_tpu_torch.ops import segprog as tseg

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

WRAPS = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1], np.uint32)


def _u32(rng, shape):
    x = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = x.reshape(-1)
    flat[:WRAPS.size] = WRAPS
    return x


def _t(a):  # numpy -> torch, u32 as int64
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def _ulps(a, b):
    """|a - b| in units in the last place (f32, same-sign ordering)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def test_utof23_bit_exact():
    cnt = _u32(np.random.default_rng(0), (4, 1000))
    ref = np.asarray(jscan.utof23(jnp.asarray(cnt)))
    got = tscan.utof23(_t(cnt)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_ftou32_bit_exact():
    v = np.random.default_rng(1).uniform(0, 1, 2000).astype(np.float32)
    v[:4] = [0.0, 0.5, 0.99999994, 1.0]
    ref = np.asarray(jscan.ftou32(jnp.asarray(v)))
    got = tscan.ftou32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_phase_from_chunk_bit_exact():
    rng = np.random.default_rng(2)
    V, n = 5, 4096
    vals = {"ifreq": _u32(rng, (V, n)), "A": _u32(rng, (V, n)),
            "valid": (rng.uniform(size=(V, n)) > 0.3).astype(np.float32)}
    t_idx = (np.arange(n) + 18_400_000).astype(np.int32)
    jc, ji, jv = josc.phase_from_chunk({k: jnp.asarray(v) for k, v in vals.items()},
                                       jnp.asarray(t_idx))
    tc, ti, tv = tosc.phase_from_chunk({k: _t(v) for k, v in vals.items()},
                                       torch.from_numpy(t_idx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji).astype(np.int64))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tc.min() >= 0 and tc.max() <= 2 ** 32 - 1


@pytest.mark.parametrize("phase", ["zero", "array"])
def test_sine_wave(phase):
    rng = np.random.default_rng(3)
    cnt = _u32(rng, (3, 3000))
    ph = 0.0 if phase == "zero" else rng.uniform(-1, 1, cnt.shape).astype(np.float32)
    ref = np.asarray(josc.sine_wave(jnp.asarray(cnt), ph if phase == "zero"
                                    else jnp.asarray(ph)))
    got = tosc.sine_wave(_t(cnt), ph if phase == "zero" else torch.from_numpy(ph))
    assert np.abs(got.numpy() - ref).max() < 1e-6


@pytest.mark.parametrize("color", ["scalar", "per_voice"])
def test_pulse_wave(color):
    rng = np.random.default_rng(4)
    V, n = 6, 4000
    cnt = _u32(rng, (V, n))
    ifreq = rng.integers(0, 2 ** 29, (V, n), dtype=np.int64).astype(np.uint32)
    ifreq[0, :50] = 0
    ifreq[1, :50] = 2 ** 32 - 1
    valid = rng.uniform(size=(V, n)) > 0.2
    if color == "scalar":
        col_np, col_t = 0.25, 0.25
    else:
        col_np = rng.uniform(0, 1, (V, 1)).astype(np.float32)
        col_np[0] = 1.5  # clipped to 1
        col_t = torch.from_numpy(col_np)
    ref = np.asarray(josc.pulse_wave(jnp.asarray(cnt), jnp.asarray(ifreq),
                                     col_np, jnp.asarray(valid)))
    got = tosc.pulse_wave(_t(cnt), _t(ifreq), col_t, torch.from_numpy(valid)).numpy()
    # transition samples (where the anti-aliasing gain term is used)
    brpt = np.asarray(jscan.ftou32(jnp.clip(jnp.asarray(col_np, jnp.float32), 0.0, 1.0)))
    prev = (cnt - ifreq) < brpt
    cur = cnt < brpt
    trans = ((cnt < ifreq) | (prev & ~cur)) & valid
    assert trans.sum() > 100 and (~trans).sum() > 1000
    np.testing.assert_array_equal(got[~trans], ref[~trans])
    assert _ulps(got[trans], ref[trans]).max() <= 4


def _tiled_case(rng, V, nt, tile, S, c0):
    n = nt * tile
    tb = np.empty((V, nt, S), np.int32)
    tb[:, :, 0] = -(2 ** 31)
    tb[:, :, 1:] = (np.sort(rng.integers(0, tile + 4, (V, nt, S - 1)), axis=-1)
                    + c0 + np.arange(nt)[None, :, None] * tile)
    vals = {
        "f": rng.standard_normal((V, nt, S)).astype(np.float32),
        "i": rng.integers(-9, 9, (V, nt, S)).astype(np.int32),
        "u": _u32(rng, (V, nt, S)),
    }
    return tb, vals, (np.arange(n) + c0).astype(np.int32)


def test_eval_tiled_chunk_bit_exact():
    rng = np.random.default_rng(5)
    tb, vals, t_idx = _tiled_case(rng, 4, 8, 512, 3, 3 * 4096)
    ref = jseg.eval_tiled_chunk({"tb": jnp.asarray(tb),
                                 **{k: jnp.asarray(v) for k, v in vals.items()}},
                                jnp.asarray(t_idx))
    got = tseg.eval_tiled_chunk({"tb": torch.from_numpy(tb),
                                 **{k: _t(v) for k, v in vals.items()}},
                                torch.from_numpy(t_idx))
    for k in vals:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(ref[k]).astype(got[k].numpy().dtype))


def test_eval_painter_within_1ulp():
    rng = np.random.default_rng(6)
    V, n = 5, 8192
    t_idx = (np.arange(n) + 96_000).astype(np.int32)
    vals = {
        "a": rng.uniform(-1, 1, (V, n)).astype(np.float32),
        "b": rng.uniform(-1, 1, (V, n)).astype(np.float32),
        "t_step": (1.0 / rng.uniform(100, 50_000, (V, n))).astype(np.float32),
        "t0": rng.uniform(0, 0.5, (V, n)).astype(np.float32),
        "shape": rng.integers(0, 5, (V, n)).astype(np.int32),
        "seg_start": (t_idx[None, :] - rng.integers(0, 60_000, (V, n))).astype(np.int32),
    }
    ref = np.asarray(jctl.eval_painter({k: jnp.asarray(v) for k, v in vals.items()},
                                       jnp.asarray(t_idx)))
    got = tctl.eval_painter({k: torch.from_numpy(v) for k, v in vals.items()},
                            torch.from_numpy(t_idx)).numpy()
    assert _ulps(got, ref).max() <= 1


def test_affine2_scan_matches_sequential():
    """The plain scan (two-level and flat) against the sequential
    recurrence in float64."""
    rng = np.random.default_rng(7)
    for n in (1536, 200):
        m = [rng.uniform(-0.6, 0.6, (3, n)).astype(np.float32) for _ in range(6)]
        s0 = rng.standard_normal((2, 3)).astype(np.float32)
        pre_l, pre_b, post_l, post_b = tscan.affine2_scan(
            tuple(torch.from_numpy(e) for e in m), torch.from_numpy(s0[0]),
            torch.from_numpy(s0[1]))
        l, b = s0[0].astype(np.float64), s0[1].astype(np.float64)
        seq = np.empty((2, 3, n))
        for i in range(n):
            a, bb, c, d, e, f = (x[:, i] for x in m)
            l, b = a * l + bb * b + e, c * l + d * b + f
            seq[:, :, i] = l, b
        assert np.abs(post_l.numpy() - seq[0]).max() < 1e-5
        assert np.abs(post_b.numpy() - seq[1]).max() < 1e-5
        np.testing.assert_array_equal(pre_l.numpy()[:, 1:], post_l.numpy()[:, :-1])
        np.testing.assert_array_equal(pre_b.numpy()[:, 0], s0[1])
