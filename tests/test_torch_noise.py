"""The port's noise module (zang_tpu_torch/ops/noise.py) and the
per-sample-frequency oscillators trisaw_naive and cycle against zang_tpu's.

The threefry generator must give jax.random's bits (the examples' noise
tape is part of the audio): keys, fold_in, random bits and uniform are held
bit for bit, for the two example seeds and for draws of odd and even sizes.
Pink noise runs through affine1_scan in both packages: < -120 dBFS RMS, tap
states within 1e-6. The oscillators' u32 counters are bit-exact, and so are
their values (the JAX ops run one by one, not under jit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zang_tpu.ops import noise as jnoise
from zang_tpu.ops import oscillators as josc
from zang_tpu_torch.ops import noise as tnoise
from zang_tpu_torch.ops import oscillators as tosc

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SEEDS = [0xA0D10, 0xDE7]  # the stereo and detuned examples' keys
SR = 48000.0


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


def _key_data(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def test_jax_counter_layout_is_the_one_ported():
    """The port reproduces the counter layout of jax_threefry_partitionable
    = True; the other layout gives other bits."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [0, 2 ** 31 - 1])
def test_prng_key_and_fold_in_bit_for_bit(seed):
    assert tnoise.prng_key(seed) == _key_data(jax.random.PRNGKey(seed))
    for data in (0, 1, 16384, 5 * 16384, 65536 * 281, 2 ** 31 - 1):
        want = _key_data(jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(data)))
        assert tnoise.fold_in(tnoise.prng_key(seed), data) == want


def test_threefry_on_ints_and_tensors_agree():
    """The hash takes Python ints (keys, on the host) or int64 tensors
    (draws, on the device): the same words either way."""
    k = tnoise.prng_key(SEEDS[0])
    x = [0, 1, 77, 2 ** 32 - 1]
    t1, t2 = tnoise.threefry2x32(*k, 0, torch.tensor(x, dtype=torch.int64))
    for i, xi in enumerate(x):
        assert (int(t1[i]), int(t2[i])) == tnoise.threefry2x32(*k, 0, xi)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(2, 16384), (2, 1001), (39, 512), (3, 777), (5,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_uniform_bit_for_bit(seed, shape):
    t0 = 3 * 16384
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(t0))
    tkey = tnoise.fold_in(tnoise.prng_key(seed), t0)
    bits = tnoise.random_bits(tkey, shape, "cpu").numpy()
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(jkey, shape)))
    got = tnoise.uniform(tkey, shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want = np.asarray(jax.random.uniform(jkey, shape, dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 <= want.min() and want.max() < 1.0


def test_white_noise_bit_for_bit():
    jkey = jax.random.fold_in(jax.random.PRNGKey(SEEDS[1]), jnp.int32(16384))
    jw, jt = jnoise.white_noise(jkey, (2, 4096))
    tw, tt = tnoise.white_noise(tnoise.fold_in(tnoise.prng_key(SEEDS[1]), 16384),
                                (2, 4096), "cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert -1.0 <= tw.min() and tw.max() < 1.0 and abs(float(tw.mean())) < 0.05


def test_random_bits_refuses_a_draw_past_the_low_counter_word():
    with pytest.raises(ValueError, match="high word"):
        tnoise.random_bits((0, 1), (2 ** 16, 2 ** 16), "meta")


@pytest.mark.parametrize("reset", [False, True], ids=["continuous", "reset_mask"])
@pytest.mark.parametrize("n", [4096, 1000])
def test_pink_from_tape(reset, n):
    """Two chained calls (the tap states carried), with and without the
    reference's restart quirk every 128 samples."""
    rng = np.random.default_rng(5)
    V = 3
    jb = tb = None
    for _ in range(2):
        tape = rng.uniform(0.0, 1.0, (V, n)).astype(np.float32)
        mask = None
        if reset:
            mask = np.zeros((V, n), bool)
            mask[:, ::128] = True
        jo, jb = jnoise.pink_from_tape(jnp.asarray(tape), jb,
                                       None if mask is None else jnp.asarray(mask))
        to, tb = tnoise.pink_from_tape(torch.from_numpy(tape), tb,
                                       None if mask is None else torch.from_numpy(mask))
        assert to.shape == (V, n) and tb.shape == (V, 7)
        assert _rms_db(to.numpy(), jo) < -120.0
        assert np.abs(tb.numpy() - np.asarray(jb)).max() < 1e-6
        assert np.abs(np.asarray(jo)).max() > 0.5


@pytest.mark.parametrize("color", [0.0, 0.5, 0.9])
def test_trisaw_naive_wave_bit_for_bit(color):
    rng = np.random.default_rng(6)
    cnt = rng.integers(0, 1 << 32, 100000, dtype=np.uint64).astype(np.uint32)
    act = rng.uniform(size=cnt.size) > 0.1
    got = tosc.trisaw_naive_wave(torch.from_numpy(cnt.astype(np.int64)), color,
                                 torch.from_numpy(act))
    want = josc.trisaw_naive_wave(jnp.asarray(cnt), color, jnp.asarray(act))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("osc", ["trisaw_naive", "cycle"])
def test_per_sample_frequency_oscillators(osc):
    """Counters chained over two calls, with a mask and negative
    frequencies: the u32 counters and the values bit for bit."""
    rng = np.random.default_rng(7)
    V, n = 3, 3000
    t_cnt = torch.zeros(V, dtype=torch.int64)
    j_cnt = jnp.zeros(V, jnp.uint32)
    for _ in range(2):
        freq = rng.uniform(-900.0, 5000.0, (V, n)).astype(np.float32)
        act = rng.uniform(size=(V, n)) > 0.2
        if osc == "cycle":
            t_cnt, to = tosc.cycle(t_cnt, torch.from_numpy(freq), SR, torch.from_numpy(act))
            j_cnt, jo = josc.cycle(j_cnt, jnp.asarray(freq), SR, jnp.asarray(act))
        else:
            t_cnt, to = tosc.trisaw_naive(t_cnt, torch.from_numpy(freq), 0.0, SR,
                                          torch.from_numpy(act))
            j_cnt, jo = josc.trisaw_naive(j_cnt, jnp.asarray(freq), 0.0, SR,
                                          jnp.asarray(act))
        np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt).astype(np.int64))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert (to.numpy()[~act] == 0.0).all() and np.abs(to.numpy()).max() > 0.5
