"""The port's FM feedback oscillator (zang_tpu_torch/ops/fm.py) against
zang_tpu's.

fm_feedback_ref, the plain torch loop, is held to the JAX package's Pallas
kernel in interpret mode and to its lax.scan path. Both sides take sin from
different libraries (torch's CPU sin, XLA's), so the comparisons stay in the
contractive regime (feedback pi/4 < 1), with the bounds of
tests/test_ops_effects.py:324-346: rms < -100 dBFS, end states within 1e-4.
Waveform 3 decides on the sign of sin(2p): a sample whose |sin 2p| is
within a few ulps of 0 can flip between the two libraries, so those flips
are counted and the comparison of a voice stops at its first one. The CUDA
kernel is held to the plain version on the card in
tests/test_torch_cuda_kernels.py (marker `cuda`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.ops import fm as jfm
from zang_tpu.ops.pallas_fm import fm_feedback_pallas
from zang_tpu.ops.scan import exclusive_cumsum_u32 as j_cumsum
from zang_tpu.ops.scan import freq_to_ifreq as j_ifreq
from zang_tpu.ops.scan import utof23 as j_utof23
from zang_tpu_torch.ops import fm as tfm
from zang_tpu_torch.parallel.mesh import launch_counts

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

FB = np.float32(np.pi / 4)  # _FEEDBACK[3], the fmsynth example's
SR = 48000.0
WAVEFORMS = [0, 1, 2, 3]


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


def _freqs(rng, V, n):
    """Per-voice note frequencies held for runs of samples, as a note
    program gives them."""
    f = rng.uniform(80.0, 1200.0, (V, 1)).astype(np.float32)
    return np.repeat(f, n, axis=1)


def _base(freq):
    """Phase angles [V, n] as fm_osc makes them (JAX ops, so both sides of
    a comparison read the same f32 angles)."""
    cnt = j_cumsum(j_ifreq(jnp.asarray(freq), SR))
    return np.array(j_utof23(cnt) * np.float32(np.pi) * np.float32(2.0))


def _angles(base, out, fb1, fb2, fb):
    """p of every sample, rebuilt from a run's outputs (f32, the kernel's
    order)."""
    V, n = base.shape
    prev1 = np.concatenate([fb1[:, None], out[:, :-1]], axis=1)
    prev2 = np.concatenate([fb2[:, None], prev1[:, :-1]], axis=1)
    return base + (prev1 + prev2) * np.asarray(fb, np.float32).reshape(-1, 1)


def _hold(got, ref, waveform, p_ref=None):
    """got vs ref within the bounds; for waveform 3 each voice is compared
    up to its first sign flip of sin(2p) (|diff| > 0.1, and |sin 2p| < 1e-5
    where the angles p_ref are known). Returns the number of flips."""
    got, ref = np.asarray(got), np.asarray(ref)
    if waveform != 3:
        assert _rms_db(got, ref) < -100.0
        return 0
    flips = 0
    for v in range(got.shape[0]):
        bad = np.abs(got[v] - ref[v]) > 0.1
        if p_ref is not None:
            near = np.abs(np.sin(2.0 * p_ref[v].astype(np.float64))) < 1e-5
            first = bad & (np.cumsum(bad) == 1)
            assert not (first & ~near).any(), f"voice {v}: a difference away from a flip"
        stop = int(np.argmax(bad)) if bad.any() else got.shape[1]
        flips += int(bad.any())
        if stop:
            assert _rms_db(got[v, :stop], ref[v, :stop]) < -100.0
    assert flips <= 1
    return flips


def _plain(base, fb, waveform, fb1, fb2):
    out, f1, f2 = tfm.fm_feedback_ref(torch.from_numpy(base), fb, waveform,
                                      torch.from_numpy(fb1), torch.from_numpy(fb2))
    return out.numpy(), f1.numpy(), f2.numpy()


@pytest.mark.parametrize("waveform", WAVEFORMS)
def test_plain_matches_pallas_interpret(waveform):
    """fm_feedback_ref vs the TPU kernel (interpret mode), 8 voices (the
    example's), two 512-row tiles and a ragged tail, a carried start state."""
    rng = np.random.default_rng(10 + waveform)
    V, n = 8, 1100
    base = _base(_freqs(rng, V, n))
    fb1 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    fb2 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    out, f1, f2 = _plain(base, float(FB), waveform, fb1, fb2)
    jo, jf1, jf2 = fm_feedback_pallas(jnp.asarray(base), FB, waveform, jnp.asarray(fb1),
                                      jnp.asarray(fb2), interpret=True)
    flips = _hold(out, jo, waveform, _angles(base, out, fb1, fb2, FB))
    if not flips:
        assert np.abs(f1 - np.asarray(jf1)).max() < 1e-4
        assert np.abs(f2 - np.asarray(jf2)).max() < 1e-4


@pytest.mark.parametrize("waveform", WAVEFORMS)
def test_plain_per_voice_operands_match_pallas_interpret(waveform):
    """feedback as a per-voice array and waveform as an int32 tensor, as the
    TPU kernel takes them (pallas_fm.py:94-97): fm_feedback_ref against the
    kernel in interpret mode with the same per-voice feedback."""
    rng = np.random.default_rng(80 + waveform)
    V, n = 6, 700
    base = _base(_freqs(rng, V, n))
    fb = rng.uniform(0.1, 0.9, V).astype(np.float32)
    fb1 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    fb2 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    out, f1, f2 = _plain(base, torch.from_numpy(fb), torch.tensor(waveform, dtype=torch.int32),
                         fb1, fb2)
    jo, jf1, jf2 = fm_feedback_pallas(jnp.asarray(base), jnp.asarray(fb), waveform,
                                      jnp.asarray(fb1), jnp.asarray(fb2), interpret=True)
    if not _hold(out, jo, waveform, _angles(base, out, fb1, fb2, fb)):
        assert np.abs(f1 - np.asarray(jf1)).max() < 1e-4
        assert np.abs(f2 - np.asarray(jf2)).max() < 1e-4


@pytest.mark.parametrize("form", ["feedback [V]", "feedback []", "feedback [1]",
                                  "waveform []", "waveform [1]"])
def test_plain_operand_forms_give_the_number_bits(form):
    """A tensor feedback that holds the same value for every voice, or a
    waveform tensor, gives the bits of the number."""
    rng = np.random.default_rng(90)
    V, n = 4, 300
    base = _base(_freqs(rng, V, n))
    fb1 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    fb2 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    fb, w = float(FB), 3
    want = _plain(base, fb, w, fb1, fb2)
    shape = {"[V]": (V,), "[]": (), "[1]": (1,)}[form.split()[1]]
    if form.startswith("feedback"):
        fb = torch.full(shape, FB, dtype=torch.float32)
    else:
        w = torch.full(shape, w, dtype=torch.int32)
    got = _plain(base, fb, w, fb1, fb2)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def _fm_osc_pair(rng, V, n, waveform, calls=2, masked=True):
    """fm_osc through both packages (the port's plain loop on the CPU, the
    JAX package's lax.scan), chained over `calls` calls with the counters and
    the feedback carry passed on. Returns the port's and JAX's
    (outs, cnt_end, fb1, fb2)."""
    cnt0 = rng.integers(0, 2 ** 32, V, dtype=np.uint64).astype(np.uint32)
    t_state = (torch.from_numpy(cnt0.astype(np.int64)),
               (torch.zeros(V), torch.zeros(V)))
    j_state = (jnp.asarray(cnt0), (jnp.zeros(V), jnp.zeros(V)))
    t_outs, j_outs = [], []
    for _ in range(calls):
        freq = _freqs(rng, V, n)
        act = rng.uniform(size=(V, n)) > 0.2 if masked else None
        tc, tfb, to = tfm.fm_osc(t_state[0], torch.from_numpy(freq), 0.0, waveform,
                                 float(FB), t_state[1], SR,
                                 None if act is None else torch.from_numpy(act))
        jc, jfb, jo = jfm.fm_osc(j_state[0], jnp.asarray(freq), 0.0, waveform,
                                 float(FB), j_state[1], SR,
                                 None if act is None else jnp.asarray(act))
        t_state, j_state = (tc, tfb), (jc, jfb)
        t_outs.append(to.numpy())
        j_outs.append(np.asarray(jo))
    return ((np.concatenate(t_outs, 1), t_state[0].numpy(), t_state[1][0].numpy(),
             t_state[1][1].numpy()),
            (np.concatenate(j_outs, 1), np.asarray(j_state[0]),
             np.asarray(j_state[1][0]), np.asarray(j_state[1][1])))


@pytest.mark.parametrize("waveform", WAVEFORMS)
def test_fm_osc_chain_with_mask_matches_scan(waveform):
    """fm_osc over two chained calls with an active mask: the phase counters
    bit for bit, the outputs and the carried (fb1, fb2) within the bounds.
    The mask zeroes inactive outputs; the carry keeps the unmasked ones."""
    rng = np.random.default_rng(30 + waveform)
    (to, tc, t1, t2), (jo, jc, j1, j2) = _fm_osc_pair(rng, 4, 600, waveform)
    np.testing.assert_array_equal(tc, jc.astype(np.int64))
    if not _hold(to, jo, waveform):
        assert np.abs(t1 - j1).max() < 1e-4 and np.abs(t2 - j2).max() < 1e-4


def test_fm_osc_more_voices_than_lanes_matches_scan():
    """160 voices, beyond the TPU kernel's 128 lanes (fm_feedback_pallas's
    limit); the port has no such limit."""
    rng = np.random.default_rng(40)
    (to, tc, t1, t2), (jo, jc, j1, j2) = _fm_osc_pair(rng, 160, 256, 0, calls=1,
                                                      masked=False)
    np.testing.assert_array_equal(tc, jc.astype(np.int64))
    assert _rms_db(to, jo) < -100.0
    assert np.abs(t1 - j1).max() < 1e-4 and np.abs(t2 - j2).max() < 1e-4


@pytest.mark.parametrize("waveform", WAVEFORMS)
def test_fm_osc_zero_feedback_matches_jax(waveform):
    """A literal 0.0 feedback takes the parallel path in both packages (the
    carrier's); the new carry is the last two masked outputs."""
    rng = np.random.default_rng(50 + waveform)
    V, n = 3, 2048
    freq = _freqs(rng, V, n)
    act = rng.uniform(size=(V, n)) > 0.2
    cnt0 = np.zeros(V, np.uint32)
    tc, (t1, t2), to = tfm.fm_osc(torch.zeros(V, dtype=torch.int64),
                                  torch.from_numpy(freq), 0.25, waveform, 0.0,
                                  (torch.zeros(V), torch.zeros(V)), SR,
                                  torch.from_numpy(act))
    jc, (j1, j2), jo = jfm.fm_osc(jnp.asarray(cnt0), jnp.asarray(freq), 0.25, waveform,
                                  0.0, (jnp.zeros(V), jnp.zeros(V)), SR,
                                  jnp.asarray(act))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    assert _rms_db(to.numpy(), jo) < -120.0
    np.testing.assert_array_equal(t1.numpy(), to.numpy()[:, -1])
    np.testing.assert_array_equal(t2.numpy(), to.numpy()[:, -2])


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """No switch: a CPU tensor goes to fm_feedback_ref, and the kernel's
    wrapper is never reached."""
    def no_kernel(*a, **k):
        raise AssertionError("the CUDA wrapper was reached from a CPU tensor")

    monkeypatch.setattr(tfm, "fm_feedback_cuda", no_kernel)
    before = launch_counts()["fm_feedback"]
    base = torch.from_numpy(_base(_freqs(np.random.default_rng(60), 2, 64)))
    z = torch.zeros(2)
    got = tfm.fm_feedback(base, float(FB), 0, z, z)
    ref = tfm.fm_feedback_ref(base, float(FB), 0, z, z)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    tfm.fm_osc(torch.zeros(2, dtype=torch.int64), torch.full((2, 64), 220.0), 0.0, 0,
               float(FB), (z, z), SR)
    assert launch_counts()["fm_feedback"] == before


def test_zero_feedback_reaches_no_recurrence(monkeypatch):
    def no_recurrence(*a, **k):
        raise AssertionError("a literal 0.0 feedback reached fm_feedback")

    monkeypatch.setattr(tfm, "fm_feedback", no_recurrence)
    z = torch.zeros(2)
    tfm.fm_osc(torch.zeros(2, dtype=torch.int64), torch.full((2, 64), 220.0), 0.0, 0,
               0.0, (z, z), SR)


def test_wrapper_raises_on_cpu_tensor():
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fm_feedback_cuda(torch.zeros(2, 64), float(FB), 0, z, z)


def test_plain_waveform_a_voice_matches_pallas_interpret():
    """A waveform a voice (an int32 tensor [V], waveforms 0-3 mixed, as a
    fleet's lanes give them) with feedback a voice: fm_feedback_ref
    against the TPU kernel in interpret mode, which takes a waveform a lane
    (pallas_fm.py:47,93-97)."""
    rng = np.random.default_rng(90)
    V, n = 8, 600
    base = _base(_freqs(rng, V, n))
    fb = rng.uniform(0.1, 0.9, V).astype(np.float32)
    waves = np.arange(V, dtype=np.int32) % 4
    fb1 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    fb2 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    out, _, _ = _plain(base, torch.from_numpy(fb), torch.from_numpy(waves), fb1, fb2)
    jo, _, _ = fm_feedback_pallas(jnp.asarray(base), jnp.asarray(fb), jnp.asarray(waves),
                                  jnp.asarray(fb1), jnp.asarray(fb2), interpret=True)
    p = _angles(base, out, fb1, fb2, fb)
    for w in range(4):
        voices = waves == w
        _hold(out[voices], np.asarray(jo)[voices], w, p[voices])


def test_plain_waveform_a_voice_is_each_voice_alone():
    """The plain loop with a waveform a voice gives each voice the bits of
    a run with that voice's waveform as a number."""
    rng = np.random.default_rng(91)
    V, n = 6, 300
    base = _base(_freqs(rng, V, n))
    fb1 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    fb2 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    waves = np.array([3, 0, 2, 1, 3, 2], np.int32)
    out, f1, f2 = _plain(base, float(FB), torch.from_numpy(waves), fb1, fb2)
    for w in range(4):
        o, g1, g2 = _plain(base, float(FB), w, fb1, fb2)
        voices = waves == w
        np.testing.assert_array_equal(out[voices], o[voices])
        np.testing.assert_array_equal(f1[voices], g1[voices])


def test_fm_osc_tensor_feedback_takes_the_recurrence(monkeypatch):
    """A tensor feedback always reaches fm_feedback (its value lives on the
    card and is not read back), even when it is zero."""
    seen = []
    ref = tfm.fm_feedback

    def spy(*a, **k):
        seen.append(a[1])
        return ref(*a, **k)

    monkeypatch.setattr(tfm, "fm_feedback", spy)
    z = torch.zeros(2)
    tfm.fm_osc(torch.zeros(2, dtype=torch.int64), torch.full((2, 64), 220.0), 0.0,
               torch.tensor([0, 2], dtype=torch.int32), torch.zeros(2), (z, z), SR)
    assert len(seen) == 1
