"""The port's sampler path against zang_tpu's: the table lookup (K4), its
two-tap entry and its fused entry (the sampler's whole chunk), the
sampler's plans and taps, distortion and the decimator, and the sampler
config end to end.

JAX runs on the CPU as its own tests run it: the Pallas lookup kernel in
interpret mode (tests/test_ops_effects.py TestPallasTableLookup), and
eval_sampler's kernel route under ZANG_LOOKUP_INTERPRET=1. Tolerances:
the lookup, plans, taps, the fused entry's plain version (sampler_play_ref
against the JAX package's eval_tiled_chunk and eval_sampler), decimator
and the chain without distortion are bit-exact; distortion is within 1e-6 absolute (atan and exp2 differ by
ulps between XLA:CPU and torch); the whole chain with distortion is held
below -110 dBFS RMS (tests/test_configs.py:52). The CUDA kernel is held to
its plain version on the card in tests/test_torch_cuda_kernels.py (marker
`cuda`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zang_tpu.core.notes import SongEvent
from zang_tpu.core.timeline import compile_timelines
from zang_tpu.core.wav import WavData
from zang_tpu.graph.render import render_performance as jrender
from zang_tpu.host import configs as jconfigs
from zang_tpu.ops import effects as jfx
from zang_tpu.ops import sampler as jsam
from zang_tpu.ops import scan as jscan
from zang_tpu.ops.pallas_lookup import TILE, pack_table, table_lookup_pallas
from zang_tpu.ops import segprog as jseg
from zang_tpu.ops.segprog import eval_chunk
from zang_tpu_torch import convert
from zang_tpu_torch.core.wav import read_wav
from zang_tpu_torch.graph.fidelity import deviation_dbfs
from zang_tpu_torch.graph.render import host_slices
from zang_tpu_torch.graph.render import render_performance as trender
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import render_wav
from zang_tpu_torch.ops import effects as tfx
from zang_tpu_torch.ops import lookup
from zang_tpu_torch.ops import sampler as tsam
from zang_tpu_torch.ops import scan as tscan
from zang_tpu_torch.parallel.mesh import launch_counts
from zang_tpu_torch.ops import segprog as tseg

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 44100.0


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


# ---------------------------------------------------------------------------
# K4: the table lookup


def _lookup_case(seed, N, nt, p_sel=0.8, out_of_range=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal(N).astype(np.float32)
    lo, hi = (-300, N + 300) if out_of_range else (0, N)
    idx = rng.integers(lo, hi, (nt, TILE)).astype(np.int32)
    sel = (rng.random((nt, TILE)) < p_sel).astype(np.float32)
    return idx, sel, table


@pytest.mark.parametrize("case", [
    dict(seed=0, N=22050, nt=8),                     # random indices
    dict(seed=1, N=1000, nt=3),                      # nt not a multiple of 8
    dict(seed=2, N=35280, nt=5, p_sel=0.3),          # the drum loop, sel mostly 0
    dict(seed=3, N=4097, nt=2, out_of_range=True),   # outside [0, N): 0
])
def test_lookup_ref_matches_pallas_interpret(case):
    idx, sel, table = _lookup_case(**case)
    want = np.asarray(table_lookup_pallas(jnp.asarray(idx), jnp.asarray(sel),
                                          pack_table(jnp.asarray(table)),
                                          interpret=True))
    got = lookup.table_lookup_ref(torch.from_numpy(idx), torch.from_numpy(sel),
                                  torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == 0).sum() >= (sel == 0).sum()
    # the wrapper takes the plain version for CPU tensors
    before = launch_counts()["table_lookup"]
    np.testing.assert_array_equal(
        lookup.table_lookup(torch.from_numpy(idx), torch.from_numpy(sel),
                            torch.from_numpy(table)).numpy(), want)
    assert launch_counts()["table_lookup"] == before


def test_lookup_kernel_raises_on_cpu_tensor():
    idx, sel, table = (torch.from_numpy(a) for a in _lookup_case(0, 100, 1))
    with pytest.raises(ValueError, match="CUDA"):
        lookup.table_lookup_cuda(idx, sel, table)


# ---------------------------------------------------------------------------
# K4's two-tap entry: both of the sampler's taps, wrapped or clipped, at once


def _per_tap(idx, table, num_samples, loop):
    """One tap the per-tap way: wrap (loop) or clip and sel in torch, then
    the generic lookup."""
    if loop:
        sel = torch.ones(idx.shape, dtype=torch.float32)
        idx = torch.remainder(idx, num_samples)
    else:
        sel = ((idx >= 0) & (idx < num_samples)).to(torch.float32)
        idx = torch.clamp(idx, 0, num_samples - 1)
    return lookup.table_lookup(idx.to(torch.int32).contiguous(), sel, table)


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


@pytest.mark.parametrize("name", list(TAPS_CASES))
def test_sampler_taps_ref_matches_per_tap_and_pallas(name):
    """The two-tap plain version against one tap at a time (the wrap in
    torch, then the lookup) and against the JAX package's _pallas_taps (the
    Pallas lookup in interpret mode), bit for bit: looped and one shot,
    negative indices, indices >= N, a table longer than 262,144 samples."""
    kw = dict(TAPS_CASES[name])
    loop = kw.pop("loop")
    ia, ib, table = _taps_case(**kw)
    N = table.shape[0]
    ta, tb_, tt = torch.from_numpy(ia), torch.from_numpy(ib), torch.from_numpy(table)
    got = lookup.sampler_taps_ref(ta, tb_, tt, N, loop)
    assert got.shape == (2, *ia.shape) and got.dtype == torch.float32
    for k, idx in enumerate((ta, tb_)):
        assert torch.equal(got[k], _per_tap(idx, tt, N, loop))
        ok = jnp.ones(idx.shape, dtype=bool)
        want = np.asarray(jsam._pallas_taps(jnp.asarray(idx.numpy()), ok, jnp.asarray(table),
                                            N, loop, interpret=True))
        np.testing.assert_array_equal(got[k].numpy(), want)
    if loop:
        assert (got != 0).all()
    else:
        outside = (ia < 0) | (ia >= N)
        assert (got[0].numpy()[outside] == 0).all()
        assert outside.any() != (name == "one_shot")
    # the router takes the plain version for CPU tensors and launches nothing
    before = launch_counts()["table_lookup"]
    assert torch.equal(lookup.sampler_taps(ta, tb_, tt, N, loop), got)
    assert launch_counts()["table_lookup"] == before


def test_sampler_taps_kernel_raises_on_cpu_tensor():
    ia, ib, table = (torch.from_numpy(a) for a in _taps_case(0, 100, 512, 0, 100))
    with pytest.raises(ValueError, match="CUDA"):
        lookup.sampler_taps_cuda(ia, ib, table, 100, True)


# ---------------------------------------------------------------------------
# plans and taps


def _sampler_case(loop, speed, seconds=1.5, note_gap=0.8):
    """The cases of tests/test_ops_effects.py TestSamplerPallasTaps."""
    total = int(seconds * SR)
    song, t, nid = [], 0.0, 1
    while t < seconds - 0.2:
        song.append(SongEvent({"note_on": True}, t=t, note_id=nid))
        t += note_gap
        nid += 1
    tls = compile_timelines(song, 1, SR, total)
    kw = dict(loop=loop, speed=speed, distort=False, fake_sample_rate=None)
    return tls, jconfigs.SamplerInstrument(**kw), tconfigs.SamplerInstrument(**kw)


CASES = {
    "looped_forward": dict(loop=True, speed=1.3),
    "looped_reverse": dict(loop=True, speed=-1.0),
    "one_shot": dict(loop=False, speed=2.0, seconds=2.5),
    "dense_retriggers": dict(loop=True, speed=0.9, note_gap=0.018),
    "copy_fast_path": dict(loop=True, speed=1.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plan_sampler_bit_identical(name):
    tls, jinst, tinst = _sampler_case(**CASES[name])
    jp, tp = jinst.plan(tls, SR), tinst.plan(tls, SR)
    assert tinst.ratio == jinst.ratio
    np.testing.assert_array_equal(tp["sampler"].starts, jp["sampler"].starts)
    assert tp["sampler"].values.keys() == jp["sampler"].values.keys()
    for k, v in jp["sampler"].values.items():
        assert tp["sampler"].values[k].dtype == v.dtype
        np.testing.assert_array_equal(tp["sampler"].values[k], v)


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_decode_wav_channel(bits):
    rng = np.random.default_rng(bits)
    data = rng.integers(0, 256, 2 * (bits // 8) * 999, dtype=np.uint8).tobytes()
    w = WavData(num_channels=2, sample_rate=22050, bits_per_sample=bits, data=data)
    for ch in (0, 1, 2):
        ref, got = jsam.decode_wav_channel(w, ch), tsam.decode_wav_channel(w, ch)
        np.testing.assert_array_equal(got.data_f32, ref.data_f32)
        assert (got.num_samples, got.byte_len, got.sample_rate) == \
               (ref.num_samples, ref.byte_len, ref.sample_rate)


@pytest.mark.parametrize("windowed", [False, True], ids=["gather", "lookup"])
@pytest.mark.parametrize("name", ["looped_forward", "looped_reverse", "one_shot",
                                  "dense_retriggers"])
def test_eval_sampler_bit_exact(name, windowed, monkeypatch):
    """The port's taps (always the lookup, here its plain version) against
    both of the JAX package's routes: its gather and its Pallas lookup."""
    tls, jinst, tinst = _sampler_case(**CASES[name])
    prog = jinst.plan(tls, SR)
    tinst.plan(tls, SR)
    n = 8192
    sp = prog["sampler"]
    vals = eval_chunk({"starts": sp.starts.astype(np.int32), **sp.values},
                      jnp.arange(n, dtype=jnp.int32))
    # the JAX package's kernel route: the Pallas lookup in interpret mode
    monkeypatch.setenv("ZANG_LOOKUP_INTERPRET", "1" if windowed else "0")
    want = np.asarray(jsam.eval_sampler(
        vals, jnp.arange(n, dtype=jnp.int32), jnp.asarray(jinst.table.data_f32),
        jinst.table.num_samples, jinst.ratio, jinst.loop, windowed=windowed))
    got = tsam.eval_sampler(
        {k: _t(v) for k, v in vals.items()}, torch.arange(n, dtype=torch.int32),
        torch.from_numpy(tinst.table.data_f32), tinst.table.num_samples,
        tinst.ratio, tinst.loop)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("loop", [True, False], ids=["looped", "one_shot"])
def test_eval_sampler_long_table(loop):
    """A table longer than the TPU kernel's limit (128 x 2048 samples),
    which the JAX package reads with its gather: the port takes the lookup
    all the same. The window crosses the table's end at ratio 1.3."""
    N = 300_000
    rng = np.random.default_rng(9)
    data = rng.standard_normal(N).astype(np.float32)
    table = jsam.SampleTable(data, N, 2 * N, 1.3 * SR)
    total = int(8.0 * SR)
    tls = compile_timelines([SongEvent({"note_on": True}, t=0.0, note_id=1)], 1, SR, total)
    prog = jsam.plan_sampler(tls[0], table, SR, loop)
    assert np.array_equal(
        tsam.plan_sampler(tls[0], tsam.SampleTable(data, N, 2 * N, 1.3 * SR), SR,
                          loop).values["t0"], prog.values["t0"])
    ratio = float(np.float32(np.float32(1.3 * SR) / np.float32(SR)))
    t_idx = np.arange(226_000, 226_000 + 8192, dtype=np.int32)
    vals = eval_chunk({"starts": prog.starts.astype(np.int32), **prog.values},
                      jnp.asarray(t_idx))
    want = np.asarray(jsam.eval_sampler(vals, jnp.asarray(t_idx), jnp.asarray(data), N,
                                        ratio, loop, windowed=False))
    got = tsam.eval_sampler({k: _t(v) for k, v in vals.items()}, torch.from_numpy(t_idx),
                            torch.from_numpy(data), N, ratio, loop)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0 and (want == 0).any() != loop


# ---------------------------------------------------------------------------
# K4's fused entry: the sampler's whole chunk from its tiled program

# name -> _sampler_case's arguments. The drum loop is at 22,050 Hz, so the
# playback ratio is speed / 2 at 44,100 Hz: speed 2.0 is ratio 1.0, the copy
# fast path (mode 2), and the sampler config's speed 1.0 is ratio 0.5. A
# note_gap past the piece's length is one note at frame 0, the sampler
# config's program (S = 1 slot a tile)
PLAY_CASES = {
    "looped_ratio_1.0": dict(loop=True, speed=2.0),              # mode 2
    "looped_ratio_0.5": dict(loop=True, speed=1.0),              # mode 1
    "looped_ratio_0.7": dict(loop=True, speed=1.4),
    "looped_ratio_1.3": dict(loop=True, speed=2.6),
    "looped_reverse": dict(loop=True, speed=-2.0),               # through the remainder
    "looped_reverse_0.7": dict(loop=True, speed=-1.4),
    "one_shot_ratio_1.0": dict(loop=False, speed=2.0, seconds=2.5),
    "one_shot_ratio_1.3": dict(loop=False, speed=2.6, seconds=2.5),  # past the end
    "one_shot_reverse": dict(loop=False, speed=-2.0),            # mode 0 throughout
    "one_note_ratio_1.3": dict(loop=True, speed=2.6, note_gap=10.0),  # S = 1
    "one_note_ratio_1.0": dict(loop=True, speed=2.0, note_gap=10.0),
    "dense_retriggers": dict(loop=True, speed=1.8, note_gap=0.005),  # S > 2
}
PLAY_CHUNK = 8192


def _play_programs(name):
    """(chunked tiled program [nc, V, nt, S] arrays, table f32, num_samples,
    ratio, loop) of a PLAY_CASES entry or of the long table ("long_table_
    looped", "long_table_one_shot": 300,000 samples at ratio 1.3, the
    window crossing the table's end)."""
    if name.startswith("long_table"):
        loop = name.endswith("looped")
        N = 300_000
        data = np.random.default_rng(9).standard_normal(N).astype(np.float32)
        total = int(8.0 * SR)
        tls = compile_timelines([SongEvent({"note_on": True}, t=0.0, note_id=1)], 1, SR,
                                total)
        sp = tsam.plan_sampler(tls[0], tsam.SampleTable(data, N, 2 * N, 1.3 * SR), SR, loop)
        ratio = float(np.float32(np.float32(1.3 * SR) / np.float32(SR)))
        return tseg.chunkify_tiled(sp, PLAY_CHUNK, -(-total // PLAY_CHUNK), total), data, \
            N, ratio, loop
    tls, _, tinst = _sampler_case(**PLAY_CASES[name])
    sp = tinst.plan(tls, SR)["sampler"]
    total = tls[0].total
    return (tseg.chunkify_tiled(sp, PLAY_CHUNK, -(-total // PLAY_CHUNK), total),
            tinst.table.data_f32, tinst.table.num_samples, tinst.ratio, tinst.loop)


@pytest.mark.parametrize("name", [*PLAY_CASES, "long_table_looped", "long_table_one_shot"])
def test_sampler_play_ref_matches_jax(name):
    """sampler_play_ref on every chunk of a real tiled program (plan_sampler,
    chunkify_tiled) against the JAX package's eval_tiled_chunk and
    eval_sampler (its gather path), bit for bit; the router takes the plain
    version for CPU tensors and launches nothing."""
    xs, data, N, ratio, loop = _play_programs(name)
    n_chunks, V, nt, S = xs["tb"].shape
    assert (S == 1) == name.startswith(("one_note", "long_table"))
    if name == "dense_retriggers":
        assert S > 2
    modes = set()
    table = torch.from_numpy(data)
    for c in range(n_chunks):
        t_idx = np.arange(c * PLAY_CHUNK, (c + 1) * PLAY_CHUNK, dtype=np.int32)
        prog = {k: v[c] for k, v in xs.items()}
        vals = jseg.eval_tiled_chunk({k: jnp.asarray(v) for k, v in prog.items()},
                                     jnp.asarray(t_idx))
        want = np.asarray(jsam.eval_sampler(vals, jnp.asarray(t_idx), jnp.asarray(data), N,
                                            ratio, loop, windowed=False))
        tprog = {k: torch.from_numpy(v) for k, v in prog.items()}
        got = tsam.sampler_play_ref(tprog, torch.from_numpy(t_idx), table, N, ratio, loop)
        assert got.shape == (V, PLAY_CHUNK) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        before = (launch_counts()["table_lookup"], launch_counts()["sampler_play"])
        routed = tsam.sampler_play(tprog, torch.from_numpy(t_idx), table, N, ratio, loop)
        assert torch.equal(routed.view(torch.int32), got.view(torch.int32))
        assert (launch_counts()["table_lookup"], launch_counts()["sampler_play"]) == before
        modes |= set(np.unique(prog["mode"]).tolist())
    assert modes == ({0} if name == "one_shot_reverse" else
                     {2} if name.endswith("ratio_1.0") else {1})


def test_sampler_play_cuda_raises_on_cpu_tensor():
    xs, data, N, ratio, loop = _play_programs("looped_ratio_1.3")
    prog = {k: torch.from_numpy(v[0]) for k, v in xs.items()}
    t_idx = torch.arange(PLAY_CHUNK, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lookup.sampler_play_cuda(prog, t_idx, torch.from_numpy(data), N, ratio, loop)


# the eager ops of the chain sampler_play replaces that do no work on a
# device: views, and the taps' output (the stand-in below allocates it)
_NO_WORK = {"aten.view.default", "aten.alias.default", "aten.expand.default",
            "aten._unsafe_view.default", "aten.unsqueeze.default", "aten.unbind.int",
            "aten.empty.memory_format", "aten.slice.Tensor", "aten.select.int"}


def test_fused_entry_replaces_the_chain_s_device_ops():
    """Counts, by dispatch on the CPU, the device ops a chunk of the chain
    that SamplerInstrument.render ran before the fused entry
    (eval_tiled_chunk, then eval_sampler with its one taps launch) at the
    sampler config's program (S = 1 slot a tile) and at three slots: every
    op that is not a view is a launch on the card, the host ratio
    (as_f32, aten.lift_fresh here) a copy to it. The fused entry is one
    launch, so the sampler's launches a chunk fall by the count less one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    def taps_stand_in(idx_a, idx_b, table, num_samples, loop):
        return torch.empty((2, *idx_a.shape))  # one launch on the card

    counts = {}
    for name, chunk in (("config", 65536), ("config", 16384), ("dense_retriggers", 8192)):
        if name == "config":
            perf, total = tconfigs.build_sampler_performance()
            xs, _ = host_slices(perf, total, chunk)
            prog = {k: torch.from_numpy(v[1]) for k, v in xs[0]["sampler"].items()}
            inst = perf.parts[0][0]
            data, N, ratio, loop = inst.table.data_f32, inst.table.num_samples, \
                inst.ratio, inst.loop
        else:
            xs, data, N, ratio, loop = _play_programs(name)
            prog = {k: torch.from_numpy(v[1]) for k, v in xs.items()}
        t_idx = torch.arange(chunk, dtype=torch.int32) + chunk
        table = torch.from_numpy(data)
        with Ops() as ops:
            chain = tsam.eval_sampler(tseg.eval_tiled_chunk(prog, t_idx), t_idx, table, N,
                                      ratio, loop, taps=taps_stand_in)
        work = [o for o in ops.names if o not in _NO_WORK]
        S = prog["tb"].shape[2]
        counts[(name, chunk)] = (S, len(work) + 1)  # the taps' one launch
        print(f"{name} at chunk {chunk}, S = {S}: {len(work) + 1} device ops in the chain; "
              f"the fused entry 1")
        assert chain.shape == (1, chunk)
    # S = 1: three reshape copies of the expanded slot values, 25 ops of
    # eval_sampler, the ratio's upload and the taps; each further slot a
    # compare and three selects, and no reshape copies
    assert counts[("config", 65536)] == (1, 29)
    assert counts[("config", 16384)] == (1, 29)
    S = counts[("dense_retriggers", 8192)][0]
    assert counts[("dense_retriggers", 8192)] == (S, 26 + 4 * (S - 1))


# ---------------------------------------------------------------------------
# scan pieces and effects


def test_exclusive_cumsum_u32_bit_exact():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2 ** 32, (3, 5000), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jscan.exclusive_cumsum_u32(jnp.asarray(x)))
    np.testing.assert_array_equal(tscan.exclusive_cumsum_u32(_t(x)).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("n", [700, 4096])
def test_affine1_scan(n):
    """Random one-pole maps within 1e-6 (association order differs), the
    latch (a in {0, 1}) bit-exact; the flat path (n = 700) and the two-level
    one."""
    rng = np.random.default_rng(n)
    a = rng.uniform(-0.99, 0.99, (2, n)).astype(np.float32)
    u = rng.standard_normal((2, n)).astype(np.float32)
    s0 = rng.standard_normal(2).astype(np.float32)
    jscan1 = jax.jit(jscan.affine1_scan)
    want = np.asarray(jscan1(jnp.asarray(a), jnp.asarray(u), jnp.asarray(s0)))
    got = tscan.affine1_scan(_t(a), _t(u), _t(s0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    trig = rng.random((2, n)) < 0.01
    a, u = np.where(trig, 0, 1).astype(np.float32), np.where(trig, u, 0).astype(np.float32)
    want = np.asarray(jscan1(jnp.asarray(a), jnp.asarray(u), jnp.asarray(s0)))
    np.testing.assert_array_equal(tscan.affine1_scan(_t(a), _t(u), _t(s0)).numpy(), want)


@pytest.mark.parametrize("kind", ["overdrive", "clip"])
def test_distortion(kind):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 3000)) * 0.8).astype(np.float32)
    ingain = rng.uniform(0, 1, (2, 3000)).astype(np.float32)
    for params in ((0.9, 0.5, 0.0), (ingain, 0.7, 0.1)):
        want = np.asarray(jfx.distortion(jnp.asarray(x), kind,
                                         *(jnp.asarray(p) for p in params)))
        got = tfx.distortion(_t(x), kind, *(_t(p) if isinstance(p, np.ndarray) else p
                                            for p in params)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


DEC_CASES = {
    "6000": dict(fake=6000.0),
    "1858_host_division": dict(fake=1858.0),  # XLA's reciprocal is 1 ulp off here
    "passthrough": dict(fake=48000.0),
    "silent": dict(fake=0.0),
    "at_rate": dict(fake=44100.0),       # fake == sr passes through
    "below_rate": dict(fake=44099.0),    # the largest step below a wrap
    "negative": dict(fake=-100.0),       # holds forever, as fake = 0
}


@pytest.mark.parametrize("name", list(DEC_CASES))
def test_decimator_bit_exact(name):
    """Output and end states (counter, held value), chained over two calls."""
    fake = DEC_CASES[name]["fake"]
    rng = np.random.default_rng(len(name))
    V, n = 3, 2048
    x = rng.standard_normal((V, 2 * n)).astype(np.float32)
    jcnt, jval = jnp.full((V,), 0xFFFFFFFF, jnp.uint32), jnp.zeros((V,), jnp.float32)
    tcnt = torch.full((V,), 0xFFFFFFFF, dtype=torch.int64)
    tval = torch.zeros((V,), dtype=torch.float32)
    for k in range(2):
        sl = slice(k * n, (k + 1) * n)
        jcnt, jval, jout = jfx.decimator(jcnt, jval, jnp.asarray(x[:, sl]), fake, SR)
        tcnt, tval, tout = tfx.decimator(tcnt, tval, _t(x[:, sl]), fake, SR)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt).astype(np.int64))
        np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))


# ---------------------------------------------------------------------------
# the sampler config end to end


@pytest.mark.parametrize("kw, exact", [
    (dict(), False),                                      # the full chain
    (dict(distort=False), True),                          # sampler + decimator
    (dict(distort=False, fake_sample_rate=None), True),   # sampler alone
    (dict(speed=-1.0, distort=False, fake_sample_rate=None), True),  # reverse
], ids=["chain", "no_distortion", "sampler_only", "reverse"])
def test_sampler_config_matches_jax(kw, exact):
    """build_sampler_performance(seconds=3.0) by both packages at chunk
    16,384; the full chain measured -155.3 dBFS RMS on the CPU."""
    jperf, total = jconfigs.build_sampler_performance(seconds=3.0, **kw)
    want = np.asarray(jrender(jperf, total, chunk_size=16384))
    tperf, total2 = tconfigs.build_sampler_performance(seconds=3.0, **kw)
    got = trender(tperf, total2, 16384, device="cpu")
    assert total2 == total and got.shape == (1, total) and got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(want).max() > 0.1
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert deviation_dbfs(got, want)[0] < -110.0
    # the JAX package's own programs and state, carried across
    perf = convert.from_jax_performance(jperf, "cpu")
    state = convert.from_jax_state(jperf.init_state(), "cpu")
    assert state[0][0]["dec_cnt"].dtype == torch.int64
    torch.testing.assert_close(state, tperf.init_state("cpu"), rtol=0, atol=0)
    np.testing.assert_array_equal(
        trender(perf, total, 16384, device="cpu", state=state).numpy(), got)


def test_render_wav_sampler_cli(tmp_path, capsys):
    out = tmp_path / "sampler.wav"
    render_wav.main(["sampler", str(out), "--seconds", "0.5", "--device", "cpu"])
    wav = read_wav(str(out))
    assert (wav.sample_rate, wav.num_channels) == (44100, 1)
    pcm = np.frombuffer(wav.data, np.int16)
    assert pcm.size == 22050 and np.count_nonzero(pcm) > 10000
    np.testing.assert_array_equal(
        pcm, tconfigs.render_config_s16("sampler", 0.5, device="cpu")[0])
    assert "rendered 0.5s at 44100Hz (1 ch)" in capsys.readouterr().out
