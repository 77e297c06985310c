"""The port's five CUDA kernels against their plain torch versions on the
card (marker `cuda`; each case skips without CUDA, since a CUDA kernel has
no CPU mode).

This file imports neither jax nor zang_tpu, so it runs where the card is,
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py tests/test_torch_cuda_paths.py

The cases and their bounds are those the JAX-side port tests held them to:
K1 and K2 (the table-cut and dense-cut SVF) against svf_filter_table_ref /
svf_filter_ref at rms < -120 dBFS with end states within 1e-5 and against
their seams composed in torch; K3 (the one-pass SVF) and K5 (FM feedback)
bit for bit with their loops (K5 within -100 dBFS of fm_feedback through
its router, waveform 3 up to a sign flip of sin 2p); K4 (the table lookup,
its two-tap entry and its fused entry, the sampler's whole chunk) bit for
bit, and the sampler config's render through the fused entry bit for bit
with its render through the chain it replaced. Their input helpers are copies of
tests/test_torch_{svf,fm,onepass,sampler}.py's, the FM phase angles made
with the port's u32 ops (bit for bit with the JAX package's,
tests/test_torch_ops.py). K3's batch-edge cases (ONEPASS_EDGES,
onepass_edge_case) are defined here; tests/test_torch_onepass.py holds the
loop to the JAX package at the same inputs.
"""

import numpy as np
import pytest
import torch

from zang_tpu_torch.core import twelve_tet
from zang_tpu_torch.core.notes import SongEvent
from zang_tpu_torch.core.timeline import compile_timelines
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.ops import filters as tfilt
from zang_tpu_torch.ops import fm as tfm
from zang_tpu_torch.ops import lookup, svf_cuda
from zang_tpu_torch.ops import sampler as tsam
from zang_tpu_torch.ops import scan as tscan
from zang_tpu_torch.ops import segprog as tseg
from zang_tpu_torch.parallel.mesh import launch_counts

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


# ---------------------------------------------------------------------------
# K1, the table-cut SVF (from tests/test_torch_svf.py)


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


def _assert_close(got, ref):
    lt, bt, ot = (np.asarray(v) for v in got)
    lr, br, orf = (np.asarray(v) for v in ref)
    assert _rms_db(ot, orf) < -120.0
    assert np.abs(lt - lr).max() < 1e-5 and np.abs(bt - br).max() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(14, 128, 512, 2), (3, 4, 512, 3), (6, 128, 16, 3)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    V, nt, T, S = shape
    c = _case(5, V=V, nt=nt, T=T, S=S, t0=7 * 65536)
    args = _torch_args(c, "low_pass", cuda_device)
    before = launch_counts()["svf_table"]
    got = tfilt.svf_filter_table(*args)
    ref = tfilt.svf_filter_table_ref(*args)
    torch.cuda.synchronize()
    assert launch_counts()["svf_table"] == before + 1
    _assert_close(tuple(v.cpu() for v in got), tuple(v.cpu() for v in ref))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(14, 128, 512, 2), (5, 32, 512, 3), (2, 512, 24, 5)])
def test_kernel_matches_emulation_on_card(cuda_device, shape):
    """The kernel against its seams composed in torch on the card."""
    V, nt, T, S = shape
    c = _case(6, V=V, nt=nt, T=T, S=S, t0=3 * 65536)
    args = _torch_args(c, "low_pass", cuda_device)
    got = svf_cuda.svf_table_cuda(*args)
    want = svf_cuda.svf_table_emulated(*args)
    torch.cuda.synchronize()
    _assert_close(tuple(v.cpu() for v in got), tuple(v.cpu() for v in want))


@pytest.mark.cuda
def test_kernel_raises_on_refused_shape(cuda_device):
    """A chunk that runs of 16 frames do not tile raises; nothing falls
    back to the plain version."""
    c = _case(7, V=2, nt=8, T=125, S=3)
    before = launch_counts()["svf_table"]
    with pytest.raises(ValueError, match="multiple of 16"):
        tfilt.svf_filter_table(*_torch_args(c, "low_pass", cuda_device))
    assert launch_counts()["svf_table"] == before


# ---------------------------------------------------------------------------
# K2, the dense-cut SVF (from tests/test_torch_svf.py)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 16384, "scalar"), (3, 1000, "column"), (1024, 4096, "dense"), (5, 777, "dense")])
def test_dense_kernel_matches_plain_on_card(cuda_device, shape):
    V, n, form = shape
    c = _dense_case(13, V, n, dense=form == "dense")
    args = list(_dense_torch(c, "low_pass", cuda_device))
    if form == "scalar":
        args[4] = 0.2
    before = launch_counts()["svf_dense"]
    got = tfilt.svf_filter(*args)
    ref = tfilt.svf_filter_ref(*args)
    torch.cuda.synchronize()
    assert launch_counts()["svf_dense"] == before + 1
    _assert_close(tuple(v.cpu() for v in got), tuple(v.cpu() for v in ref))


@pytest.mark.cuda
@pytest.mark.parametrize("name", EXAMPLE_CASES)
def test_dense_kernel_is_its_emulation_on_card(cuda_device, name):
    """K2 against its seams composed in torch on the card, bit for bit."""
    args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                 for a in _example_case(name))
    got = svf_cuda.svf_dense_cuda(*args)
    want = svf_cuda.svf_dense_emulated(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# K3, the one-pass SVF (from tests/test_torch_onepass.py)


def _onepass_case(seed, V, n, nt, S, t0):
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 2048, 128, 3), (5000, 1000, 8, 4),
                                   (4100, 768, 8, 2), (33, 640, 5, 1)])
def test_kernel_is_the_loop_on_card(cuda_device, shape):
    V, n, nt, S = shape
    c = _onepass_case(12, V, n, nt, max(S, 2), 7 * 65536)
    if S == 1:
        c["tb"], c["cutv"] = c["tb"][:, :, :1].copy(), c["cutv"][:, :, :1].copy()
    args = _args(c, "low_pass", lambda a: torch.from_numpy(a).to(cuda_device))
    before = launch_counts()["svf_onepass"]
    x = args[2].clone()
    got = svf_cuda.svf_onepass_cuda(*args[:2], x, *args[3:], out=x)
    ref = tfilt.svf_onepass_table_ref(*args)
    torch.cuda.synchronize()
    assert launch_counts()["svf_onepass"] == before + 1 and got[2] is x
    assert all(torch.equal(g, w) for g, w in zip(got, ref))


# K3's batches (csrc/svf_onepass.cu): a chain lane steps K3_BATCH samples
# at a time, a warp of 32 voices together, and takes one of three paths a
# batch (every lane active from its first sample: no select, and one
# cutoff when no lane's boundary falls after that sample; no lane active:
# zeros; else the plain loop's selects), or a sample at a time where a time
# tile ends inside a batch or an x tile is ragged. These cases put
# active_from and the slot boundaries where the paths part. name -> (V, n,
# nt, S, active from, boundaries):
#   active from  "random" t0 .. t0 + n/2; "warps" by warp of 32 voices:
#                inside a batch, on a batch's first sample, before the chunk,
#                after it; "none" (always active)
#   boundaries   "random" sorted in the tile; "batches" even warps inside a
#                batch, odd ones on a batch's first sample; "unsorted"
#                random, in no order (the last slot in order whose
#                boundary has passed wins)
K3_BATCH = 32  # csrc/svf_onepass.cu kBatch
ONEPASS_EDGES = {
    "af in batches": (128, 1024, 8, 2, "warps", "random"),
    "boundaries in and on batches": (64, 1024, 4, 3, "none", "batches"),
    "unsorted boundaries": (64, 512, 2, 4, "none", "unsorted"),
    "tile ends in a batch": (40, 640, 16, 2, "random", "random"),
    "tiles of 48": (33, 768, 16, 2, "warps", "batches"),  # batches that cross a tile end
    "a tile of 64 batches and more": (40, 4096, 1, 3, "warps", "batches"),
    "S1": (70, 512, 4, 1, "warps", "random"),
    "S2": (70, 512, 4, 2, "warps", "batches"),
    "S3": (70, 512, 4, 3, "warps", "batches"),
    "S4": (70, 512, 4, 4, "warps", "batches"),
    "V 97": (97, 1024, 8, 3, "warps", "batches"),
    "n 644": (33, 644, 7, 3, "random", "random"),  # n = 4 (mod 128): a ragged x tile
}


def onepass_edge_case(name, seed=21, t0=7 * 65536):
    """The inputs of ONEPASS_EDGES[name] as numpy arrays (af None when
    always active), in _onepass_case's format."""
    V, n, nt, S, af_mode, tb_mode = ONEPASS_EDGES[name]
    rng = np.random.default_rng(seed)
    T, batch = n // nt, K3_BATCH
    pos = rng.integers(0, T, (V, nt, S - 1))
    if tb_mode == "batches":
        odd = (np.arange(V) // 32 % 2 == 1)[:, None, None]
        pos = np.minimum(pos // batch * batch + np.where(odd, 0, rng.integers(1, batch, pos.shape)),
                         T - 1)
    if tb_mode != "unsorted":
        pos = np.sort(pos, axis=-1)
    tb = np.empty((V, nt, S), np.int32)
    tb[:, :, 0] = -(2 ** 31)
    tb[:, :, 1:] = pos + t0 + np.arange(nt)[None, :, None] * T
    if af_mode == "random":
        af = rng.integers(t0, t0 + n // 2, V)
    elif af_mode == "warps":
        warp = np.arange(V) // 32 % 4
        at = t0 + rng.integers(0, n // batch, V) * batch
        af = np.select([warp == 0, warp == 1, warp == 2],
                       [at + rng.integers(1, batch, V), at, np.full(V, t0 - 3)], t0 + n + 5)
    return dict(
        tb=tb, cutv=rng.uniform(0.05, 0.9, (V, nt, S)).astype(np.float32),
        af=None if af_mode == "none" else af.astype(np.int32),
        x=(rng.standard_normal((V, n)) * 0.3).astype(np.float32),
        l0=(rng.standard_normal(V) * 0.1).astype(np.float32),
        b0=(rng.standard_normal(V) * 0.1).astype(np.float32), t0=t0)


def onepass_edge_args(c, device, ftype="low_pass"):
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return (to(c["l0"]), to(c["b0"]), to(c["x"]), ftype, to(c["tb"]), to(c["cutv"]), 0.3,
            c["t0"], to(c["af"]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ONEPASS_EDGES))
def test_kernel_is_the_loop_at_its_batch_edges_on_card(cuda_device, name):
    """Written over x, bit for bit with the loop."""
    args = onepass_edge_args(onepass_edge_case(name), cuda_device)
    x = args[2].clone()
    got = svf_cuda.svf_onepass_cuda(*args[:2], x, *args[3:], out=x)
    ref = tfilt.svf_onepass_table_ref(*args)
    torch.cuda.synchronize()
    assert got[2] is x and all(torch.equal(g, w) for g, w in zip(got, ref))
    assert float(ref[2].abs().max()) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", ["band_pass", "all_pass"])
def test_kernel_chained_into_its_own_output_on_card(cuda_device, ftype):
    """Two calls over the halves of a chunk, each into an output of its own
    (out=None), the second from the first's end state: the loop's bits over
    the whole chunk, for output mixes other than low_pass."""
    c = onepass_edge_case("V 97")
    args = onepass_edge_args(c, cuda_device, ftype)
    l_full, b_full, full = tfilt.svf_onepass_table_ref(*args)
    x, tb, cutv = args[2], args[4], args[5]
    n, nt = x.shape[1] // 2, tb.shape[1] // 2
    l, b, halves = args[0], args[1], []
    for k in range(2):
        l, b, out = svf_cuda.svf_onepass_cuda(
            l, b, x[:, k * n:(k + 1) * n].contiguous(), ftype,
            tb[:, k * nt:(k + 1) * nt].contiguous(), cutv[:, k * nt:(k + 1) * nt].contiguous(),
            0.3, c["t0"] + k * n, args[8])
        halves.append(out)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(halves, dim=1), full)
    assert torch.equal(l, l_full) and torch.equal(b, b_full)
    assert torch.equal(x, onepass_edge_args(c, cuda_device)[2])  # x untouched


# ---------------------------------------------------------------------------
# K5, FM feedback (from tests/test_torch_fm.py)

FB = np.float32(np.pi / 4)  # _FEEDBACK[3], the fmsynth example's
FM_SR = 48000.0
WAVEFORMS = [0, 1, 2, 3]


def _freqs(rng, V, n):
    """Per-voice note frequencies held for runs of samples, as a note
    program gives them."""
    f = rng.uniform(80.0, 1200.0, (V, 1)).astype(np.float32)
    return np.repeat(f, n, axis=1)


def _base(freq):
    """Phase angles [V, n] as fm_osc makes them (the port's u32 ops, the
    JAX package's bits)."""
    cnt = tscan.exclusive_cumsum_u32(tscan.freq_to_ifreq(torch.from_numpy(freq), FM_SR))
    return (tscan.utof23(cnt) * np.float32(np.pi) * np.float32(2.0)).numpy()


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


@pytest.mark.cuda
@pytest.mark.parametrize("waveform", WAVEFORMS)
@pytest.mark.parametrize("shape", [(8, 16384), (1024, 2048), (3, 777)])
def test_fm_kernel_matches_plain_on_card(cuda_device, waveform, shape):
    V, n = shape
    rng = np.random.default_rng(70 + waveform)
    base = _base(_freqs(rng, V, n))
    fb1 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    fb2 = rng.uniform(-0.5, 0.5, V).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (base, fb1, fb2)]
    before = launch_counts()["fm_feedback"]
    got = tfm.fm_feedback(args[0], float(FB), waveform, args[1], args[2])
    ref = tfm.fm_feedback_ref(args[0], float(FB), waveform, args[1], args[2])
    torch.cuda.synchronize()
    assert launch_counts()["fm_feedback"] == before + 1
    out, ro = got[0].cpu().numpy(), ref[0].cpu().numpy()
    if not _hold(out, ro, waveform, _angles(base, ro, fb1, fb2, FB)):
        assert (got[1] - ref[1]).abs().max() < 1e-4 and (got[2] - ref[2]).abs().max() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("waveform", WAVEFORMS)
@pytest.mark.parametrize("shape", [(8, 16384), (40, 1000), (3, 777)])
def test_fm_kernel_is_the_plain_bits_on_card(cuda_device, waveform, shape):
    """Full-precision sinf and no contraction: the kernel gives the plain
    loop's bits, with feedback and waveform by value and by pointer."""
    V, n = shape
    rng = np.random.default_rng(100 + waveform)
    base, fb1, fb2 = (torch.from_numpy(a).to(cuda_device) for a in (
        _base(_freqs(rng, V, n)), rng.uniform(-0.5, 0.5, V).astype(np.float32),
        rng.uniform(-0.5, 0.5, V).astype(np.float32)))
    fb = torch.from_numpy(rng.uniform(0.1, 0.9, V).astype(np.float32)).to(cuda_device)
    w = torch.tensor([waveform], dtype=torch.int32, device=cuda_device)
    for args in ((float(FB), waveform), (fb, w)):
        got = tfm.fm_feedback_cuda(base, *args, fb1, fb2)
        want = tfm.fm_feedback_ref(base, *args, fb1, fb2)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16384), (128, 4096), (37, 777)])
def test_fm_kernel_waveform_a_voice_is_the_plain_bits_on_card(cuda_device, shape):
    """A waveform a voice (stride 1): mixed inside every warp, one a warp,
    and one for all by pointer (stride 0), bit for bit with the plain loop."""
    V, n = shape
    rng = np.random.default_rng(110)
    base, fb1, fb2 = (torch.from_numpy(a).to(cuda_device) for a in (
        _base(_freqs(rng, V, n)), rng.uniform(-0.5, 0.5, V).astype(np.float32),
        rng.uniform(-0.5, 0.5, V).astype(np.float32)))
    idx = torch.arange(V, device=cuda_device)
    for w in (idx % 4, (idx // 32) % 4, torch.tensor(3, device=cuda_device)):
        w = w.to(torch.int32)
        got = tfm.fm_feedback_cuda(base, float(FB), w, fb1, fb2)
        want = tfm.fm_feedback_ref(base, float(FB), w, fb1, fb2)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want))


# ---------------------------------------------------------------------------
# K4, the table lookup, its two-tap entry and its fused entry (from
# tests/test_torch_sampler.py)

TILE = 512  # the lookup's index tile (zang_tpu/ops/pallas_lookup.py:35)
SAMPLER_SR = 44100.0


def _lookup_case(seed, N, nt, p_sel=0.8, out_of_range=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal(N).astype(np.float32)
    lo, hi = (-300, N + 300) if out_of_range else (0, N)
    idx = rng.integers(lo, hi, (nt, TILE)).astype(np.int32)
    sel = (rng.random((nt, TILE)) < p_sel).astype(np.float32)
    return idx, sel, table


def _taps_case(seed, N, n, lo, hi, step=None):
    """idx_a from [lo, hi) (or a run from lo by step, as reverse play
    walks), idx_b = idx_a + 1, [1, n]; a table of N samples."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal(N).astype(np.float32)
    if step is None:
        a = rng.integers(lo, hi, (1, n))
    else:
        a = lo + step * np.arange(n)[None, :]
    return a.astype(np.int32), (a + 1).astype(np.int32), table


TAPS_CASES = {
    "looped": dict(loop=True, seed=20, N=35280, n=4096, lo=0, hi=35280),
    "one_shot": dict(loop=False, seed=21, N=35280, n=4096, lo=0, hi=35280),
    "reverse_looped": dict(loop=True, seed=22, N=35280, n=2048, lo=700, hi=None, step=-3),
    "reverse_one_shot": dict(loop=False, seed=23, N=35280, n=2048, lo=700, hi=None,
                             step=-3),
    "beyond_n_looped": dict(loop=True, seed=24, N=4097, n=2048, lo=-3 * 4097,
                            hi=3 * 4097),
    "beyond_n_one_shot": dict(loop=False, seed=25, N=4097, n=2048, lo=-300, hi=4097 + 300),
    "long_table_looped": dict(loop=True, seed=26, N=300_000, n=1024, lo=-400_000,
                              hi=700_000),
    "long_table_one_shot": dict(loop=False, seed=27, N=300_000, n=1024, lo=-1000,
                                hi=301_000),
}


def _sampler_case(loop, speed, seconds=1.5, note_gap=0.8):
    """The cases of tests/test_ops_effects.py TestSamplerPallasTaps: the
    timelines and the port's instrument."""
    total = int(seconds * SAMPLER_SR)
    song, t, nid = [], 0.0, 1
    while t < seconds - 0.2:
        song.append(SongEvent({"note_on": True}, t=t, note_id=nid))
        t += note_gap
        nid += 1
    tls = compile_timelines(song, 1, SAMPLER_SR, total)
    kw = dict(loop=loop, speed=speed, distort=False, fake_sample_rate=None)
    return tls, tconfigs.SamplerInstrument(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(seed=10, N=35280, nt=128),                       # the sampler's shape
    dict(seed=11, N=128 * 2048, nt=128),                  # the largest table
    dict(seed=12, N=35280, nt=7, p_sel=0.5, out_of_range=True),  # one-shot edges
])
def test_lookup_kernel_matches_plain_on_card(cuda_device, case):
    idx, sel, table = (torch.from_numpy(a).to(cuda_device) for a in _lookup_case(**case))
    before = launch_counts()["table_lookup"]
    got = lookup.table_lookup(idx, sel, table)
    want = lookup.table_lookup_ref(idx, sel, table)
    torch.cuda.synchronize()
    assert launch_counts()["table_lookup"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TAPS_CASES))
def test_sampler_taps_kernel_matches_plain_on_card(cuda_device, name):
    """One launch for both taps, bit for bit with the plain version."""
    kw = dict(TAPS_CASES[name])
    loop = kw.pop("loop")
    ia, ib, table = (torch.from_numpy(a).to(cuda_device) for a in _taps_case(**kw))
    before = launch_counts()["table_lookup"]
    got = lookup.sampler_taps(ia, ib, table, table.shape[0], loop)
    want = lookup.sampler_taps_ref(ia, ib, table, table.shape[0], loop)
    torch.cuda.synchronize()
    assert launch_counts()["table_lookup"] == before + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="num_samples"):
        lookup.sampler_taps(ia, ib, table, table.shape[0] - 1, loop)


@pytest.mark.cuda
def test_eval_sampler_on_card_matches_cpu(cuda_device):
    tls, tinst = _sampler_case(loop=True, speed=-1.0)  # "looped_reverse"
    prog = tinst.plan(tls, SAMPLER_SR)
    sp = prog["sampler"]
    n = 8192
    from zang_tpu_torch.ops.segprog import chunkify_tiled, eval_tiled_chunk

    ch = chunkify_tiled(sp, n, 1, tls[0].total, 512)
    outs = []
    for dev in ("cpu", cuda_device):
        t_idx = torch.arange(n, dtype=torch.int32, device=dev)
        vals = eval_tiled_chunk({k: torch.from_numpy(v[0]).to(dev) for k, v in ch.items()},
                                t_idx)
        outs.append(tsam.eval_sampler(vals, t_idx,
                                      torch.from_numpy(tinst.table.data_f32).to(dev),
                                      tinst.table.num_samples, tinst.ratio, True).cpu())
    assert torch.equal(outs[0], outs[1])


# tests/test_torch_sampler.py PLAY_CASES: the drum loop is at 22,050 Hz, so
# the playback ratio is speed / 2 (speed 2.0 is the copy fast path)
PLAY_CASES = {
    "looped_ratio_1.0": dict(loop=True, speed=2.0),
    "looped_ratio_0.5": dict(loop=True, speed=1.0),
    "looped_ratio_0.7": dict(loop=True, speed=1.4),
    "looped_ratio_1.3": dict(loop=True, speed=2.6),
    "looped_reverse": dict(loop=True, speed=-2.0),
    "looped_reverse_0.7": dict(loop=True, speed=-1.4),
    "one_shot_ratio_1.0": dict(loop=False, speed=2.0, seconds=2.5),
    "one_shot_ratio_1.3": dict(loop=False, speed=2.6, seconds=2.5),
    "one_shot_reverse": dict(loop=False, speed=-2.0),
    "one_note_ratio_1.3": dict(loop=True, speed=2.6, note_gap=10.0),
    "one_note_ratio_1.0": dict(loop=True, speed=2.0, note_gap=10.0),
    "dense_retriggers": dict(loop=True, speed=1.8, note_gap=0.005),
}
PLAY_CHUNK = 8192


def _play_programs(name):
    """tests/test_torch_sampler.py's _play_programs: (chunked tiled program,
    table f32, num_samples, ratio, loop) of a PLAY_CASES entry or of the
    300,000-sample table at ratio 1.3."""
    if name.startswith("long_table"):
        loop = name.endswith("looped")
        N = 300_000
        data = np.random.default_rng(9).standard_normal(N).astype(np.float32)
        total = int(8.0 * SAMPLER_SR)
        tls = compile_timelines([SongEvent({"note_on": True}, t=0.0, note_id=1)], 1,
                                SAMPLER_SR, total)
        sp = tsam.plan_sampler(tls[0], tsam.SampleTable(data, N, 2 * N, 1.3 * SAMPLER_SR),
                               SAMPLER_SR, loop)
        ratio = float(np.float32(np.float32(1.3 * SAMPLER_SR) / np.float32(SAMPLER_SR)))
        return tseg.chunkify_tiled(sp, PLAY_CHUNK, -(-total // PLAY_CHUNK), total), data, \
            N, ratio, loop
    tls, tinst = _sampler_case(**PLAY_CASES[name])
    sp = tinst.plan(tls, SAMPLER_SR)["sampler"]
    total = tls[0].total
    return (tseg.chunkify_tiled(sp, PLAY_CHUNK, -(-total // PLAY_CHUNK), total),
            tinst.table.data_f32, tinst.table.num_samples, tinst.ratio, tinst.loop)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*PLAY_CASES, "long_table_looped", "long_table_one_shot"])
def test_sampler_play_kernel_matches_plain_on_card(cuda_device, name):
    """The fused entry on every chunk of a real tiled program against
    sampler_play_ref on the card, bit for bit (signs of zero included), one
    launch a chunk on both counters."""
    xs, data, N, ratio, loop = _play_programs(name)
    table = torch.from_numpy(data).to(cuda_device)
    for c in range(xs["tb"].shape[0]):
        prog = {k: torch.from_numpy(v[c]).to(cuda_device) for k, v in xs.items()}
        t_idx = torch.arange(c * PLAY_CHUNK, (c + 1) * PLAY_CHUNK, dtype=torch.int32,
                             device=cuda_device)
        before = (launch_counts()["table_lookup"], launch_counts()["sampler_play"])
        got = tsam.sampler_play(prog, t_idx, table, N, ratio, loop)
        want = tsam.sampler_play_ref(prog, t_idx, table, N, ratio, loop)
        torch.cuda.synchronize()
        assert (launch_counts()["table_lookup"], launch_counts()["sampler_play"]) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), c
    with pytest.raises(ValueError, match="num_samples"):
        tsam.sampler_play(prog, t_idx, table, N - 1, ratio, loop)


@pytest.mark.cuda
def test_sampler_config_render_is_the_chain_s_on_card(cuda_device):
    """The sampler config (3 s at chunk 16,384, the tiled format) through the
    fused entry, one launch a chunk, bit for bit with its render through the
    chain the entry replaced (eval_tiled_chunk, then eval_sampler with the
    two-tap entry)."""
    from unittest import mock

    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.ops.segprog import eval_chunk

    perf, total = tconfigs.build_sampler_performance(seconds=3.0)
    chunks = -(-total // 16384)
    before = (launch_counts()["table_lookup"], launch_counts()["sampler_play"])
    got = render_performance(perf, total, 16384, device=cuda_device)
    torch.cuda.synchronize()
    assert (launch_counts()["table_lookup"] - before[0],
            launch_counts()["sampler_play"] - before[1]) == (chunks, chunks)

    def chain(prog, t_idx, table, num_samples, ratio, loop):
        return tsam.eval_sampler(eval_chunk(prog, t_idx), t_idx, table, num_samples,
                                 ratio, loop)

    with mock.patch.object(tsam, "sampler_play", chain):
        want = render_performance(perf, total, 16384, device=cuda_device)
    torch.cuda.synchronize()
    assert launch_counts()["sampler_play"] - before[1] == chunks
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
