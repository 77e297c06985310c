#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zang_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repo root, on a machine with CUDA, nvcc, g++ and torch. Phases,
each of which raises on failure:

  1. the card: nvidia-smi name and power limit, torch's device name
  2. build, all at once: the five CUDA kernels from zang_tpu_torch/csrc/
     (nvcc, one process per source) and the C++ host compiler (g++), into
     zang_tpu_torch/build/
  3. K1, the table-cut SVF kernel, against its plain torch version
     (svf_filter_table_ref) on the card: the song's shape, a ragged shape,
     a state chain across two calls, poly_echo's shape (1024 voices) and
     the polyphony examples' (39 and 3 voices, 16384 frames in 32 tiles);
     rms < -120 dBFS, end states within 1e-5; timed with CUDA events
     (per call) and torch.profiler (the kernel's device time)
  4. K4, the table-lookup kernel, against table_lookup_ref on the card, bit
     for bit: the sampler config's shape, the sampler example's (idx
     32 x 512), the largest table, a one-shot case with zero sel and
     out-of-range indices; timed as K1, beside the plain version and
     torch.take(table, idx) * sel
  5. K2, the dense-cut SVF kernel, against svf_filter_ref on the card:
     the play example's shape (V=1, n=16384, scalar cutoff, mask), the
     stereo example's (V=2, [2, 1] cutoff, no mask, resonance 0.4), the
     detuned example's two calls (V=2, scalar cutoff: 4 Hz, resonance 0, no
     mask; 7040 Hz with a mask), a ragged n with a [V, 1] cutoff, a state
     chain across two calls and V=1024, n=65536 with a dense cutoff and
     mask; rms < -120 dBFS, end states within 1e-5; timed as K1
  6. K5, the FM feedback kernel, against fm_feedback_ref on the card at
     feedback pi/4, waveforms 0-3: the fmsynth example's shape (V=8,
     n=16384) and V=1024 (beyond the TPU kernel's 128 lanes; the plain
     loop runs n=2048 there, the kernel is also timed at n=16384);
     rms < -100 dBFS, end states within 1e-4; waveform 3 is compared up
     to a voice's first sign flip of sin(2p), and the flips are counted.
     Its serial-chain floor is estimated by tools/fm_chain_floor.py
  6b. K3, the one-pass table-cut SVF kernel for large voice counts, against
     svf_onepass_table_ref (the sequential loop) on the card, bit for bit:
     through the router at V=4096, n=2048 with active_from inside the
     chunk, a ragged V=5000 x 1000 with time tiles of 125 frames and four
     slots written over its input, a state chain across two calls, and the
     main path's V=16384 x 65536 written over its input;
     against K1 and K1's plain version at V=4096 (rms < -120 dBFS, end
     states within 1e-5); timed beside K1 called by name at 1024, 4096 and
     16384 voices x 65536 frames
  7. the main paths, each with every kernel's launch count set to 0 just
     before it and read just after:
       song       the full 385 s Bach Toccata, render_song_s16(device="cuda"):
                  282 K1 launches
       sampler    10 s, render_config_s16("sampler", device="cuda"):
                  14 K4 launches
       poly_echo  1024 voices x 30 s stereo, render_config_s16("poly_echo",
                  device="cuda"): 21 K1 launches
       poly_echo at 4096 and at 16384 voices x 8 s (the JAX package's
                  capacity sizes), render_config_s16("poly_echo", 8.0,
                  voices=N, device="cuda"): 6 K3 launches and no K1 each,
                  peak device memory under 64 GiB
     then each again in its two timed steps (plan, device render)
  8. fidelity without JAX: each render against the JAX package's golden
     windows (zang_tpu_torch/data/*_golden_jax.npz, < -90 dBFS RMS, every
     channel) and against the card's own plain-path render (4096 voices:
     the first chunk; 16384 voices: K3 is held to its loop at that shape in
     6b instead)
  9. the twelve examples (zang_tpu_torch/host/examples.py EXAMPLES), each
     through its ex_* entry on the card at its default seconds, with the
     launch counts checked (ceil(frames / chunk) a chunk-launched kernel:
     play 18 K2, fmsynth 12 K5, polyphony 15 K1, polyphony2 18 K1,
     sampler 34 K4, song 15 K1, stereo 18 K2, detuned 30 K2 (two a chunk),
     every other count 0), against the JAX
     golden windows and against the card's plain-path render (every
     router patched to its plain version by name; fmsynth at 2 s there,
     since the plain FM loop is a Python loop over samples). detuned is
     held in two parts, as the JAX package holds its own oracle twin (its
     warble multiplier feeds a phase counter): the multiplier against the
     JAX trajectory a chunk at a time from the JAX filter state (relative
     deviation < 1e-5), and the cascade on that trajectory against the
     golden windows; the free-running render's distance is printed
  10. no module of jax or of zang_tpu was imported

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors, times and bounds. Exits non-zero,
printing no result, without CUDA or outside a checkout of the repo.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_DB = -120.0  # kernel vs plain (tests/test_ops_effects.py:270, :297)
TOL_STATE = 1e-5  # end states (tests/test_ops_effects.py:271-272)
PARITY_DB = -90.0  # the parity budget (FIDELITY.md)
CHUNK = 65536
# published H100 SXM peaks at 700 W (NVIDIA H100 datasheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
SVF_OPS_PER_SAMPLE = 21  # one SVF step and its output mix (Filter.zig:123-151)
TOL_FM_DB = -100.0  # FM kernel vs plain (tests/test_ops_effects.py:324-346)
TOL_FM_STATE = 1e-4
FB = 0.7853981633974483  # pi / 4, the fmsynth example's modulator feedback
# a feedback FM sample: 3 for the angle, 1 for the shape, and about 15 for
# sinf's range reduction and polynomial (an estimate of libdevice's fast path)
FM_OPS_PER_SAMPLE = 19


def smi(query="name,power.limit", fmt="csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rms_db(a, b) -> float:
    import numpy as np

    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30))


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel_name, reps):
    """The kernel's own device time per launch, from torch.profiler over
    `reps` calls of fn (CUDA events around back-to-back calls measure the
    wrapper's host cost too when the kernel is short)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()  # a launch at a time: fewer records dropped
    rows = [e for e in prof.key_averages() if kernel_name in e.key]
    n = sum(e.count for e in rows)
    # the profiler may drop records of a long run (it was seen to keep 168 of
    # 200): the mean is over the launches it saw, at least half of them
    if not 0.5 * reps <= n <= reps:
        raise AssertionError(f"the profiler saw {n} launches of {kernel_name}, "
                             f"expected {reps}")
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    return us / 1e3 / n


def time_pair(kernel, plain, reps_k, reps_p):
    """plain, kernel, kernel, plain in turns; returns the two means and the
    four readings."""
    p_a = time_ms(plain, reps_p)
    k_a = time_ms(kernel, reps_k)
    k_b = time_ms(kernel, reps_k)
    p_b = time_ms(plain, reps_p)
    return (k_a + k_b) / 2, (p_a + p_b) / 2, (k_a, k_b, p_a, p_b)


def timing(card, label, kernel, plain, kernel_name, n_bytes, n_ops, reps_k, reps_p,
           library=None):
    """A kernel's times at one shape: per call beside its plain version (or
    without one: plain=None) and a library call, its device time, and its
    bound from n_bytes moved and n_ops f32 operations."""
    if plain is None:
        ms, plain_ms = time_ms(kernel, reps_k), None
        r = f"kernel {ms:.4f} ms"
    else:
        ms, plain_ms, (k_a, k_b, p_a, p_b) = time_pair(kernel, plain, reps_k, reps_p)
        r = f"kernel {k_a:.4f} / {k_b:.4f} ms, plain {p_a:.4f} / {p_b:.4f} ms"
    library_ms = None
    if library is not None:
        l_a, l_b = time_ms(library[1], reps_k), time_ms(library[1], reps_k)
        library_ms = (l_a + l_b) / 2
        r += f", {library[0]} {l_a:.4f} / {l_b:.4f} ms"
    bound_ms, bound_by = bound(n_bytes, n_ops)
    dev_ms = device_ms(kernel, kernel_name, reps_k)
    print(f"  time at the {label} shape [{card}]: {r}; device {dev_ms:.4f} ms a launch; "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by}, {n_bytes} B, {n_ops} operations)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, device_ms=dev_ms)


# ---------------------------------------------------------------------------
# the SVF kernels: K1 (table cutoff) and K2 (dense cutoff)


def check_svf(label, kernel, plain, args, exact=False):
    """An SVF kernel (through its router) vs its plain version on one case:
    rms < TOL_DB, end states within TOL_STATE; with exact, bit for bit.
    Returns max |out diff|."""
    import torch

    lk, bk, ok = kernel(*args)
    lr, br, orf = plain(*args)
    torch.cuda.synchronize()
    if exact:
        same = torch.equal(ok, orf) and torch.equal(lk, lr) and torch.equal(bk, br)
        label = f"{label}: {'bit-exact' if same else 'NOT bit-exact'}"
        if not same:
            raise AssertionError(f"{label}: the kernel is not its plain loop bit for bit")
    db = rms_db(ok.cpu(), orf.cpu())
    dstate = max(float((lk - lr).abs().max()), float((bk - br).abs().max()))
    err = float((ok - orf).abs().max())
    print(f"  {label}: rms {db:.1f} dBFS, max |diff| {err:.3e}, "
          f"end state |diff| {dstate:.3e}")
    if not (db < TOL_DB and dstate < TOL_STATE):
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return err


def check_svf_chain(label, kernel, plain, args, half_args, exact=False):
    """Two chained kernel calls against one plain call over both halves;
    half_args(k, l, b) gives half k's arguments from the carried state.
    With exact, the two agree bit for bit."""
    import torch

    lr, br, full = plain(*args)
    l, b, halves = args[0], args[1], []
    for k in range(2):
        l, b, out = kernel(*half_args(k, l, b))
        halves.append(out)
    torch.cuda.synchronize()
    db = rms_db(torch.cat(halves, dim=1).cpu(), full.cpu())
    dstate = max(float((l - lr).abs().max()), float((b - br).abs().max()))
    print(f"  {label}: rms {db:.1f} dBFS, end state |diff| {dstate:.3e}")
    if not (db < TOL_DB and dstate < TOL_STATE):
        raise AssertionError(f"{label}: chained kernel calls disagree with one plain call")
    if exact and not (torch.equal(torch.cat(halves, dim=1), full) and dstate == 0.0):
        raise AssertionError(f"{label}: chained kernel calls are not the plain loop's bits")


def svf_case(rng, V, n, nt, S, t0, device):
    """Random K1 inputs in the tiled table format, with active_from. From
    2^27 samples on, x is drawn on the device (seeded from rng)."""
    import numpy as np
    import torch

    T = n // nt
    tb = np.empty((V, nt, S), np.int64)
    tb[:, :, 0] = -(2 ** 31)
    tb[:, :, 1:] = (np.sort(rng.integers(0, T, (V, nt, S - 1)), axis=-1)
                    + t0 + np.arange(nt)[None, :, None] * T)
    cutv = rng.uniform(0.05, 0.9, (V, nt, S)).astype(np.float32)
    af = rng.integers(t0, t0 + n // 2, V)
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    if V * n < 2 ** 27:
        x = to((rng.standard_normal((V, n)) * 0.3).astype(np.float32), torch.float32)
    else:
        gen = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 31)))
        x = torch.randn((V, n), generator=gen, device=device).mul_(0.3)
    l0 = (rng.standard_normal(V) * 0.1).astype(np.float32)
    b0 = (rng.standard_normal(V) * 0.1).astype(np.float32)
    return (to(l0, torch.float32), to(b0, torch.float32), x,
            "low_pass", to(tb, torch.int32), to(cutv, torch.float32), 0.7, t0,
            to(af, torch.int32))


def svf_label(label, args):
    V, n = args[2].shape
    _, nt, S = args[4].shape
    return f"{label}: V={V} n={n} nt={nt} S={S}"


def svf_table_bytes_ops(args):
    """x read, out written, the tables (tb, cutv), active_from, l0/b0 in
    and l/b out, each once; the SVF's operations on every sample."""
    V, n = args[2].shape
    _, nt, S = args[4].shape
    return 4 * (2 * V * n + 2 * V * nt * S + V + 4 * V), SVF_OPS_PER_SAMPLE * V * n


def dense_case(rng, V, n, cut_form, masked, device, res=0.7, scalar_cut=0.2):
    """Random K2 inputs: cut_form is "scalar" (the value scalar_cut), "column"
    ([V, 1]) or "dense" ([V, n])."""
    import numpy as np
    import torch

    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    cut = {"scalar": lambda: float(np.float32(scalar_cut)),
           "column": lambda: to(rng.uniform(0.05, 0.6, (V, 1)), torch.float32),
           "dense": lambda: to(rng.uniform(0.05, 0.6, (V, n)), torch.float32)}[cut_form]()
    act = to(rng.uniform(size=(V, n)) > 0.1, torch.bool) if masked else None
    return (to(rng.standard_normal(V) * 0.1, torch.float32),
            to(rng.standard_normal(V) * 0.1, torch.float32),
            to(rng.standard_normal((V, n)) * 0.3, torch.float32), "low_pass", cut, res,
            act)


def dense_label(label, args):
    import torch

    V, n = args[2].shape
    cut, act = args[4], args[6]
    form = f"{tuple(cut.shape)}" if isinstance(cut, torch.Tensor) else "scalar"
    return (f"{label}: V={V} n={n} cut {form}, res {args[5]}, "
            f"{'mask' if act is not None else 'no mask'}")


def dense_bytes_ops(args):
    """x read, out written, a dense cutoff and the mask read, l0/b0 in and
    l/b out, each once; the SVF's operations on the active samples only."""
    import torch

    V, n = args[2].shape
    cut, act = args[4], args[6]
    dense_cut = isinstance(cut, torch.Tensor) and cut.shape[-1] == n
    n_bytes = 4 * 2 * V * n + (4 * V * n if dense_cut else 0) + \
        (V * n if act is not None else 0) + 4 * 4 * V
    active = V * n if act is None else int(act.sum())
    return n_bytes, SVF_OPS_PER_SAMPLE * active


def run_onepass(card, dev, rng, filters, svf_cuda):
    """K3, the one-pass table-cut SVF kernel: against its plain loop
    (svf_onepass_table_ref; bit for bit), against K1 and K1's plain version
    (TOL_DB, TOL_STATE), and timed beside K1 called by name at 1024, 4096
    and 16384 voices x 65536 frames. Returns (errs, times, k1_times) by
    shape; the V=16384 entry carries the plain loop's one timed run."""
    import torch

    k3, k1 = svf_cuda.svf_onepass_cuda, svf_cuda.svf_table_cuda
    ref = filters.svf_onepass_table_ref
    print("K3 svf_onepass vs svf_onepass_table_ref (bit for bit), and vs K1 and "
          f"svf_filter_table_ref (rms < {TOL_DB} dBFS, end state |diff| < {TOL_STATE}):")
    errs = {}
    # through the router: V >= ONEPASS_V_MIN, active_from inside the chunk
    before = svf_cuda.svf_onepass_launches
    a = svf_case(rng, 4096, 2048, 128, 3, 512, dev)
    errs["v4096 n2048"] = check_svf(svf_label("router", a), filters.svf_filter_table, ref,
                                    a, exact=True)
    if svf_cuda.svf_onepass_launches != before + 1:
        raise AssertionError("svf_filter_table did not launch K3 at V=4096")
    # a ragged V and time tiles of 125 frames (batches that end inside a
    # tile: the kernel's sample-at-a-time steps), four slots, written over x
    a = svf_case(rng, 5000, 1000, 8, 4, 4096, dev)
    x_in = a[2].clone()

    def in_place(*args):
        l, b, out = k3(*args, out=args[2])
        if out.data_ptr() != args[2].data_ptr():
            raise AssertionError("out=x did not write in place")
        return l, b, out

    errs["ragged in place"] = check_svf(
        svf_label("ragged, out=x", a), in_place,
        lambda *args: ref(args[0], args[1], x_in, *args[3:]), a, exact=True)
    V, n, nt, t0 = 4096, 1024, 8, 2048
    chain = svf_case(rng, V, 2 * n, 2 * nt, 3, t0, dev)
    check_svf_chain(f"chained 2 x {n} at V={V}", filters.svf_filter_table, ref, chain,
                    lambda k, l, b: (l, b, chain[2][:, k * n:(k + 1) * n].contiguous(),
                                     "low_pass",
                                     chain[4][:, k * nt:(k + 1) * nt].contiguous(),
                                     chain[5][:, k * nt:(k + 1) * nt].contiguous(), 0.7,
                                     t0 + k * n, chain[8]), exact=True)
    # against the two-phase kernel and its plain version (block seams there)
    a = svf_case(rng, 4096, 16384, 32, 3, 3 * 16384, dev)
    errs["vs K1"] = check_svf(svf_label("vs K1 (svf_table_cuda)", a), k3, k1, a)
    errs["vs table ref"] = check_svf(svf_label("vs svf_filter_table_ref", a), k3,
                                     filters.svf_filter_table_ref, a)
    del a, chain

    times, k1_times = {}, {}
    for V in (1024, 4096, 16384):
        a = svf_case(rng, V, CHUNK, 128, 2, 3 * CHUNK, dev)
        key = f"v{V}"
        n_bytes, n_ops = svf_table_bytes_ops(a)
        reps = 20 if V < 16384 else 10
        times[key] = timing(card, f"K3 V={V}", lambda a=a: k3(*a), None,
                            "svf_onepass_kernel", n_bytes, n_ops, reps, 1)
        k1_times[key] = timing(card, f"K1 by name, V={V}", lambda a=a: k1(*a), None,
                               "svf_table_kernel", n_bytes, n_ops, reps, 1)
        if V == 16384:
            # the main path's shape and call (written over its input with the
            # 16-byte copies): the plain loop once, timed on the host clock,
            # and K3 held to it bit for bit
            torch.cuda.synchronize()
            t = time.perf_counter()
            want = ref(*a)
            torch.cuda.synchronize()
            times[key]["plain_ms"] = (time.perf_counter() - t) * 1e3
            x = a[2].clone()
            got = k3(a[0], a[1], x, *a[3:], out=x)
            torch.cuda.synchronize()
            if got[2].data_ptr() != x.data_ptr():
                raise AssertionError("out=x did not write in place")
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            errs[key] = float((got[2] - want[2]).abs().max())
            print(f"  {svf_label('poly_echo 16384 shape', a)}: "
                  f"{'bit-exact' if same else 'NOT bit-exact'}, max |diff| "
                  f"{errs[key]:.3e}; the plain loop took {times[key]['plain_ms']:.0f} ms")
            if not same:
                raise AssertionError("K3 is not its plain loop bit for bit at V=16384")
            del want, got, x
        del a
    return errs, times, k1_times


# ---------------------------------------------------------------------------
# K4


def lookup_case(rng, N, nt, device, p_sel=1.0, out_of_range=False):
    import torch

    table = rng.standard_normal(N).astype("float32")
    lo, hi = (-N // 4, N + N // 4) if out_of_range else (0, N)
    idx = rng.integers(lo, hi, (nt, 512)).astype("int32")
    sel = (rng.random((nt, 512)) < p_sel).astype("float32")
    return tuple(torch.from_numpy(a).to(device) for a in (idx, sel, table))


def check_lookup(lookup, case, label):
    import torch

    idx, sel, table = case
    got = lookup.table_lookup(idx, sel, table)
    want = lookup.table_lookup_ref(idx, sel, table)
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    err = float((got - want).abs().max())
    print(f"  {label}: idx {tuple(idx.shape)}, N={table.shape[0]}: "
          f"{'bit-exact' if exact else 'DIFFERS'}, max |diff| {err:.3e}, "
          f"{int((sel == 0).sum())} zero sel, "
          f"{int(((idx < 0) | (idx >= table.shape[0])).sum())} out of range")
    if not exact:
        raise AssertionError(f"{label}: table_lookup disagrees with table_lookup_ref")
    return err


# ---------------------------------------------------------------------------
# K5


def fm_case(rng, V, n, device):
    """FM feedback inputs: the phase angles of held notes (as fm_osc makes
    them, u32 counters through utof23) and a carried start state."""
    import numpy as np
    import torch

    from zang_tpu_torch.ops.scan import exclusive_cumsum_u32, freq_to_ifreq, utof23

    freq = torch.as_tensor(np.repeat(rng.uniform(80.0, 1200.0, (V, 1)), n, axis=1),
                           dtype=torch.float32, device=device)
    cnt = exclusive_cumsum_u32(freq_to_ifreq(freq, 48000.0))
    base = ((utof23(cnt) * float(np.float32(np.pi))) * 2.0).contiguous()
    to = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return dict(base=base, fb1=to(rng.uniform(-0.5, 0.5, V)),
                fb2=to(rng.uniform(-0.5, 0.5, V)))


def fm_args(c, waveform):
    return (c["base"], FB, waveform, c["fb1"], c["fb2"])


def check_fm(fm, c, waveform, label):
    """K5 (through the fm_feedback router) vs fm_feedback_ref; for waveform
    3 each voice is compared up to its first flip (|diff| > 0.1 where
    |sin 2p| < 1e-5), and the flips are counted. Returns max |out diff|
    over the compared samples."""
    import numpy as np
    import torch

    ok, f1k, f2k = fm.fm_feedback(*fm_args(c, waveform))
    orf, f1r, f2r = fm.fm_feedback_ref(*fm_args(c, waveform))
    torch.cuda.synchronize()
    got, ref = ok.cpu().numpy(), orf.cpu().numpy()
    keep = np.ones_like(got, bool)
    flips = 0
    if waveform == 3:
        base = c["base"].cpu().numpy()
        prev1 = np.concatenate([c["fb1"].cpu().numpy()[:, None], ref[:, :-1]], axis=1)
        prev2 = np.concatenate([c["fb2"].cpu().numpy()[:, None], prev1[:, :-1]], axis=1)
        p = base + (prev1 + prev2) * np.float32(FB)
        for v in range(got.shape[0]):
            bad = np.abs(got[v] - ref[v]) > 0.1
            if bad.any():
                first = int(np.argmax(bad))
                if abs(np.sin(2.0 * float(p[v, first]))) >= 1e-5:
                    raise AssertionError(f"{label}: voice {v} differs away from a flip")
                keep[v, first:] = False
                flips += 1
    db = rms_db(got[keep], ref[keep])
    err = float(np.abs(got - ref)[keep].max())
    full = keep.all(axis=1)  # voices compared to their end
    d1 = (f1k - f1r).abs().cpu().numpy()[full]
    d2 = (f2k - f2r).abs().cpu().numpy()[full]
    dstate = float(max(d1.max(), d2.max())) if full.any() else 0.0
    print(f"  {label}: V={got.shape[0]} n={got.shape[1]} waveform {waveform}: "
          f"rms {db:.1f} dBFS, max |diff| {err:.3e}, end state |diff| {dstate:.3e}, "
          f"{flips} sign flips of sin(2p)")
    if not (db < TOL_FM_DB and dstate < TOL_FM_STATE and flips <= max(1, got.shape[0] // 64)):
        raise AssertionError(f"{label}: the FM kernel disagrees with fm_feedback_ref")
    return err


def fm_bytes_ops(V, n):
    """base read, out written, fb1/fb2 in and out, each once; the FM
    operations of every sample."""
    return 4 * 2 * V * n + 4 * 4 * V, FM_OPS_PER_SAMPLE * V * n


# ---------------------------------------------------------------------------
# main paths


def counts(svf_cuda, lookup, fm):
    return {"svf_table": svf_cuda.svf_table_launches,
            "svf_dense": svf_cuda.svf_dense_launches,
            "svf_onepass": svf_cuda.svf_onepass_launches,
            "table_lookup": lookup.table_lookup_launches,
            "fm_feedback": fm.fm_feedback_launches}


def reset_counts(svf_cuda, lookup, fm):
    svf_cuda.svf_table_launches = 0
    svf_cuda.svf_dense_launches = 0
    svf_cuda.svf_onepass_launches = 0
    lookup.table_lookup_launches = 0
    fm.fm_feedback_launches = 0


def expect_counts(**n):
    return {k: n.get(k, 0) for k in ("svf_table", "svf_dense", "svf_onepass",
                                     "table_lookup", "fm_feedback")}


def check_golden(gold_windows, offsets, chunk_rms_gold, audio, label, chunk=CHUNK):
    """audio: f32 numpy [C, total]. Windows within the parity budget and
    each chunk's RMS within 10^(budget/20) of the golden's (|rms(a) - rms(b)|
    <= rms(a - b))."""
    import numpy as np

    from zang_tpu_torch.graph.fidelity import deviation_dbfs

    w = gold_windows.shape[-1]
    ours = np.stack([audio[..., o:o + w] for o in offsets])
    if ours.shape != gold_windows.shape:
        raise AssertionError(f"{label}: windows {ours.shape} vs {gold_windows.shape}")
    dbs = [deviation_dbfs(ours[:, ch], gold_windows[:, ch])
           for ch in range(ours.shape[1])] if ours.ndim == 3 else [
        deviation_dbfs(ours, gold_windows)]
    for ch, (db, peak) in enumerate(dbs):
        print(f"  {label} vs JAX golden, channel {ch} ({len(offsets)} windows of {w}): "
              f"rms {db:.1f} dBFS, peak {peak:.1f} dBFS (budget {PARITY_DB})")
        if not db < PARITY_DB:
            raise AssertionError(f"{label}: {db:.1f} dBFS from the JAX golden")
    n_chunks = chunk_rms_gold.shape[-1]
    ours_rms = np.stack([
        np.sqrt(np.mean(audio[..., i * chunk:(i + 1) * chunk].astype(np.float64) ** 2,
                        axis=-1)) for i in range(n_chunks)], axis=-1)
    d_rms = float(np.abs(ours_rms - chunk_rms_gold).max())
    print(f"  {label} per-chunk RMS vs JAX golden ({n_chunks} chunks): max |diff| "
          f"{d_rms:.3e} (bound {10 ** (PARITY_DB / 20):.3e})")
    if not d_rms < 10 ** (PARITY_DB / 20):
        raise AssertionError(f"{label}: a chunk's RMS is off the JAX golden's")
    return max(db for db, _ in dbs)


def check_plain(audio, plain_audio, label):
    from zang_tpu_torch.graph.fidelity import deviation_dbfs

    for ch in range(audio.shape[0]):
        db, peak = deviation_dbfs(audio[ch], plain_audio[ch])
        print(f"  {label} vs the card's plain-path render, channel {ch}: "
              f"rms {db:.1f} dBFS, peak {peak:.1f} dBFS")
        if not db < PARITY_DB:
            raise AssertionError(f"{label}: {db:.1f} dBFS from the plain path")


# the kernel each example launches once (twice: the sampler's two taps) a
# render chunk; the other examples launch none
EXAMPLE_KERNEL = {"play": ("svf_dense", 1), "fmsynth": ("fm_feedback", 1),
                  "polyphony": ("svf_table", 1), "polyphony2": ("svf_table", 1),
                  "sampler": ("table_lookup", 2), "song": ("svf_table", 1),
                  "stereo": ("svf_dense", 1), "detuned": ("svf_dense", 2)}
TOL_WARBLE = 1e-5  # detuned's warble multiplier vs the JAX trajectory, relative
FM_PLAIN_SECONDS = 2.0  # fmsynth's plain-path render (a Python loop over samples)


def plain_routers(filters, fm, lookup):
    """Every kernel router patched to its plain version by name."""
    from contextlib import ExitStack

    stack = ExitStack()
    for mod, attr, ref in ((filters, "svf_filter", filters.svf_filter_ref),
                           (filters, "svf_filter_table", filters.svf_filter_table_ref),
                           (fm, "fm_feedback", fm.fm_feedback_ref),
                           (lookup, "table_lookup", lookup.table_lookup_ref)):
        stack.enter_context(mock.patch.object(mod, attr, ref))
    return stack


def check_detuned(examples, filters, fm, lookup, svf_cuda, gold, p, free_np, launches):
    """The detuned example in two parts. (a) The warble multiplier of each
    chunk from the JAX package's filter state before it, against the JAX
    trajectory: relative deviation < TOL_WARBLE. (b) The cascade that
    consumes it (ex_detuned on the JAX trajectory): launch count, the golden
    windows, the card's plain path. free_np, the render on the port's own
    warble, is only measured against the golden."""
    import numpy as np
    import torch

    from zang_tpu_torch.graph.fidelity import deviation_dbfs
    from zang_tpu_torch.graph.render import RenderCtx

    warble, states = gold["detuned_warble"], gold["detuned_warble_state"]
    sr, chunk, total = p["sample_rate"], p["chunk_size"], warble.shape[1]
    base = torch.arange(chunk, dtype=torch.int32, device="cuda")
    worst = 0.0
    for i, (nl, nb) in enumerate(states):
        c0 = i * chunk
        ctx = RenderCtx(sr, base + c0, c0, chunk)
        _, _, mul = examples.DetunedInstrument.warble(
            torch.as_tensor(nl, device="cuda"), torch.as_tensor(nb, device="cuda"), ctx)
        want = warble[:, c0:c0 + chunk]
        got = mul.cpu().numpy()[:, :want.shape[1]]
        worst = max(worst, float(np.abs(got / want - 1.0).max()))
    print(f"  detuned (a) warble multiplier vs the JAX trajectory, {len(states)} chunks "
          f"from the JAX filter state: largest relative deviation {worst:.3e} "
          f"(bound {TOL_WARBLE})")
    if not worst < TOL_WARBLE:
        raise AssertionError("detuned: the warble multiplier is off the JAX trajectory")
    reset_counts(svf_cuda, lookup, fm)
    cascade = examples.ex_detuned(device="cuda", warble_mul=warble)[0].cpu().numpy()
    got = counts(svf_cuda, lookup, fm)
    launches["ex_detuned_cascade"] = got
    if got != expect_counts(svf_dense=-(-total // chunk)):
        raise AssertionError(f"detuned on the JAX trajectory: launches {got}")
    check_golden(gold["detuned_windows"], gold["detuned_offsets"],
                 gold["detuned_chunk_rms"], cascade, "detuned (b) cascade", chunk=chunk)
    reset_counts(svf_cuda, lookup, fm)
    with plain_routers(filters, fm, lookup):
        plain = examples.ex_detuned(device="cuda", warble_mul=warble)[0].cpu().numpy()
    if any(counts(svf_cuda, lookup, fm).values()):
        raise AssertionError("detuned: the plain path launched a kernel")
    check_plain(cascade, plain, "detuned (b) cascade")
    w = gold["detuned_windows"].shape[-1]
    ours = np.stack([free_np[:, o:o + w] for o in gold["detuned_offsets"]])
    dbs = [deviation_dbfs(ours[:, ch], gold["detuned_windows"][:, ch])[0] for ch in range(2)]
    print("  detuned free-running (the port's own warble) vs JAX golden, not bounded: "
          + ", ".join(f"{db:.1f}" for db in dbs) + " dBFS")


def run_examples(examples, filters, fm, lookup, svf_cuda, card, launches):
    """Each registered example through its ex_* entry on the card at its
    default seconds: launch counts, shape, finiteness, the JAX golden
    windows and the card's plain-path render. Adds each run's launch counts
    to `launches` under "ex_<name>"."""
    import inspect

    import numpy as np
    import torch

    gold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "examples_golden_jax.npz"))
    params = json.loads(str(gold["params"]))["examples"]
    if sorted(params) != sorted(examples.EXAMPLES):
        raise AssertionError(f"the examples' golden holds {sorted(params)}, the registry "
                             f"{sorted(examples.EXAMPLES)}")
    for name, fn in examples.EXAMPLES.items():
        p = params[name]
        seconds = inspect.signature(fn).parameters["seconds"].default
        chunk = examples.SONG_CHUNK if name == "song" else examples.DEFAULT_CHUNK
        if (seconds, chunk) != (p["seconds"], p["chunk_size"]):
            raise AssertionError(f"the {name} golden was made for {p}, not {seconds} s "
                                 f"at chunk {chunk}")
        total = int(seconds * p["sample_rate"])
        spent = []

        def timed_render(*a, _render=examples.render_performance, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _render(*a, **k)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t)
            return out

        reset_counts(svf_cuda, lookup, fm)
        t = time.perf_counter()
        with mock.patch.object(examples, "render_performance", timed_render):
            audio, sr = fn(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = counts(svf_cuda, lookup, fm)
        launches[f"ex_{name}"] = got
        kname, taps = EXAMPLE_KERNEL.get(name, (None, 0))
        want = expect_counts(**({kname: taps * -(-total // chunk)} if kname else {}))
        render_s = sum(spent)
        print(f"{name}: ex_{name}(device='cuda'): {tuple(audio.shape)} at {sr:g} Hz in "
              f"{wall:.3f}s end to end (plan {wall - render_s:.3f}s, device render "
              f"{render_s:.3f}s, RTF {seconds / render_s:.1f} render only), "
              f"launches {got} [{card}]")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")
        if tuple(audio.shape) != (p["channels"], total) or sr != p["sample_rate"]:
            raise AssertionError(f"{name}: {tuple(audio.shape)} at {sr}, expected "
                                 f"({p['channels']}, {total}) at {p['sample_rate']}")
        if not bool(torch.isfinite(audio).all()) or float(audio.abs().max()) < 1e-3:
            raise AssertionError(f"{name}: non-finite or silent render")
        audio_np = audio.cpu().numpy()
        if name == "detuned":
            check_detuned(examples, filters, fm, lookup, svf_cuda, gold, p, audio_np,
                          launches)
            continue
        check_golden(gold[f"{name}_windows"], gold[f"{name}_offsets"],
                     gold[f"{name}_chunk_rms"], audio_np, name, chunk=chunk)
        plain_s = FM_PLAIN_SECONDS if name == "fmsynth" else seconds
        ours = audio_np if plain_s == seconds else \
            fn(seconds=plain_s, device="cuda")[0].cpu().numpy()
        reset_counts(svf_cuda, lookup, fm)
        with plain_routers(filters, fm, lookup):
            plain = fn(seconds=plain_s, device="cuda")[0].cpu().numpy()
        if any(counts(svf_cuda, lookup, fm).values()):
            raise AssertionError(f"{name}: the plain path launched a kernel")
        check_plain(ours, plain, f"{name} ({plain_s:g} s)")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import zang_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(zang_tpu_torch.__file__))) != ROOT:
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 1
    from zang_tpu_torch.core import native
    from zang_tpu_torch.core.mixdown import mixdown_s16
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host import configs, examples, song
    from zang_tpu_torch.ops import _build, filters, fm, lookup, svf_cuda

    # 1. the card
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    dev = torch.device("cuda")

    # 2. build: one compiler process per source, all started together
    t = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        jobs = {f"{stem}.cu": pool.submit(_build.build, stem)
                for stem in ("svf_table", "svf_dense", "svf_onepass", "table_lookup",
                             "fm_feedback")}
        jobs["zang_host.cpp"] = pool.submit(native.build)
        secs = {name: job.result() for name, job in jobs.items()}
    print(f"build: {', '.join(f'{k} {v:.2f}s' for k, v in secs.items())} "
          f"(compiler time; {time.perf_counter() - t:.2f}s wall, in parallel)")

    def k1(label, a):
        return check_svf(svf_label(label, a), filters.svf_filter_table,
                         filters.svf_filter_table_ref, a)

    def k2(label, a):
        return check_svf(dense_label(label, a), filters.svf_filter, filters.svf_filter_ref, a)

    def k1_time(label, a, reps_k, reps_p):
        return timing(card, label, lambda: filters.svf_filter_table(*a),
                      lambda: filters.svf_filter_table_ref(*a), "svf_table_kernel",
                      *svf_table_bytes_ops(a), reps_k, reps_p)

    def k2_time(label, a, reps_k, reps_p):
        return timing(card, label, lambda: filters.svf_filter(*a),
                      lambda: filters.svf_filter_ref(*a), "svf_dense_kernel",
                      *dense_bytes_ops(a), reps_k, reps_p)

    # 3. K1 vs plain on the card
    rng = np.random.default_rng(20261016)
    print(f"K1 svf_table vs svf_filter_table_ref (rms < {TOL_DB} dBFS, "
          f"end state |diff| < {TOL_STATE}):")
    song_case = svf_case(rng, 14, CHUNK, 128, 2, 7 * CHUNK, dev)
    poly_case = svf_case(rng, 1024, CHUNK, 128, 2, 5 * CHUNK, dev)
    ex_chunk = examples.DEFAULT_CHUNK
    svf_err = {
        "song": max(k1("song shape", song_case),
                    k1("ragged shape", svf_case(rng, 3, 2048, 4, 3, 4096, dev))),
        "poly_echo": k1("poly_echo shape", poly_case),
        # the polyphony examples' chunk: 32 tiles of 512 frames
        "polyphony": max(k1("polyphony shape", svf_case(rng, 39, ex_chunk, 32, 2,
                                                        3 * ex_chunk, dev)),
                         k1("polyphony2 shape", svf_case(rng, 3, ex_chunk, 32, 3,
                                                         5 * ex_chunk, dev)))}
    V, n, nt, t0 = 4, 4096, 8, 1024
    chain = svf_case(rng, V, 2 * n, 2 * nt, 3, t0, dev)
    check_svf_chain(f"chained 2 x {n}", filters.svf_filter_table,
                    filters.svf_filter_table_ref, chain,
                    lambda k, l, b: (l, b, chain[2][:, k * n:(k + 1) * n].contiguous(),
                                     "low_pass",
                                     chain[4][:, k * nt:(k + 1) * nt].contiguous(),
                                     chain[5][:, k * nt:(k + 1) * nt].contiguous(), 0.7,
                                     t0 + k * n, chain[8]))
    svf_t = {"song": k1_time("song", song_case, 100, 10),
             "poly_echo": k1_time("poly_echo", poly_case, 20, 3)}
    del poly_case

    # 4. K4 vs plain on the card
    print("K4 table_lookup vs table_lookup_ref (bit for bit):")
    n_drum = configs.SamplerInstrument().table.num_samples
    sam_case = lookup_case(rng, n_drum, CHUNK // 512, dev)
    lk_err = max(
        check_lookup(lookup, sam_case, "sampler shape"),
        check_lookup(lookup, lookup_case(rng, n_drum, ex_chunk // 512, dev),
                     "sampler example shape"),
        check_lookup(lookup, lookup_case(rng, 128 * 2048, CHUNK // 512, dev),
                     "largest table"),
        check_lookup(lookup, lookup_case(rng, n_drum, CHUNK // 512, dev, p_sel=0.5,
                                         out_of_range=True), "one-shot edges"))
    idx, sel, table = sam_case
    idx_long = idx.long()  # torch.take wants int64 indices
    # idx and sel read, out written, the table read; one multiply a sample
    lk_t = timing(card, "sampler", lambda: lookup.table_lookup(idx, sel, table),
                  lambda: lookup.table_lookup_ref(idx, sel, table), "table_lookup_kernel",
                  12 * idx.numel() + 4 * table.numel(), idx.numel(), 200, 50,
                  library=("torch.take(table, idx) * sel",
                           lambda: torch.take(table, idx_long) * sel))

    # 5. K2 vs plain on the card
    print(f"K2 svf_dense vs svf_filter_ref (rms < {TOL_DB} dBFS, "
          f"end state |diff| < {TOL_STATE}):")
    play_case = dense_case(rng, 1, ex_chunk, "scalar", True, dev)
    wide_case = dense_case(rng, 1024, CHUNK, "dense", True, dev)
    dense_err = {
        "play": max(k2("play shape", play_case),
                    k2("ragged n, [V, 1] cutoff", dense_case(rng, 3, 1000, "column", True,
                                                              dev)),
                    k2("dense cutoff, no mask", dense_case(rng, 2, 4096, "dense", False,
                                                           dev))),
        # the stereo example: a [2, 1] cutoff, no mask, resonance 0.4
        "stereo": k2("stereo shape", dense_case(rng, 2, ex_chunk, "column", False, dev,
                                                res=0.4)),
        # the detuned example's two calls a chunk: the 4 Hz warble lowpass
        # (resonance 0, no mask), then the 7040 Hz lowpass under the note mask
        "detuned": max(k2("detuned warble shape",
                          dense_case(rng, 2, ex_chunk, "scalar", False, dev, res=0.0,
                                     scalar_cut=filters.cutoff_from_frequency(
                                         4.0, 48000.0))),
                       k2("detuned voice shape",
                          dense_case(rng, 2, ex_chunk, "scalar", True, dev,
                                     scalar_cut=filters.cutoff_from_frequency(
                                         7040.0, 48000.0)))),
        "v1024": k2("V=1024 shape", wide_case)}
    chain = dense_case(rng, 4, 2 * n, "dense", True, dev)
    check_svf_chain(f"chained 2 x {n}", filters.svf_filter, filters.svf_filter_ref, chain,
                    lambda k, l, b: (l, b, chain[2][:, k * n:(k + 1) * n].contiguous(),
                                     "low_pass", chain[4][:, k * n:(k + 1) * n], 0.7,
                                     chain[6][:, k * n:(k + 1) * n]))
    dense_t = {"play": k2_time("play", play_case, 100, 10),
               "v1024": k2_time("V=1024", wide_case, 20, 2)}
    del wide_case, chain

    # 6. K5 vs plain on the card
    print(f"K5 fm_feedback vs fm_feedback_ref at feedback pi/4 (rms < {TOL_FM_DB} "
          f"dBFS, end state |diff| < {TOL_FM_STATE}):")
    fm_cases = {"fmsynth": fm_case(rng, 8, ex_chunk, dev),
                "v1024 (n=2048)": fm_case(rng, 1024, 2048, dev)}  # the plain loop's n
    fm_err = {k: max(check_fm(fm, c, w, k) for w in range(4)) for k, c in fm_cases.items()}
    fm_cases["v1024"] = fm_case(rng, 1024, ex_chunk, dev)
    fm_t = {}
    for k, c in fm_cases.items():
        V, n = c["base"].shape
        kernel = lambda c=c: fm.fm_feedback(*fm_args(c, 0))
        plain = lambda c=c: fm.fm_feedback_ref(*fm_args(c, 0))
        # the plain loop is timed at n=2048 only at V=1024 (see "v1024 (n=2048)")
        fm_t[k] = timing(card, f"{k}, V={V} n={n}", kernel, None if k == "v1024" else plain,
                         "fm_feedback_kernel", *fm_bytes_ops(V, n), 20 if V < 1024 else 10, 1)
        print(f"  {fm_t[k]['device_ms'] * 1e6 / n:.2f} ns of device a step of the "
              f"{n}-step serial chain")
    del fm_cases

    # 6b. K3 vs its plain loop, K1 and K1's plain version on the card
    onepass_err, onepass_t, k1_by_name = run_onepass(card, dev, rng, filters, svf_cuda)
    svf_t.update({k: v for k, v in k1_by_name.items() if k != "v1024"})

    launches = {}

    # 7-8. the song
    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    reset_counts(svf_cuda, lookup, fm)
    t = time.perf_counter()
    pcm = song.render_song_s16(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches["song"] = counts(svf_cuda, lookup, fm)
    print(f"song: render_song_s16(device='cuda'): {pcm.shape[0]} frames in "
          f"{wall:.3f}s end to end (RTF {song.NUM_SECONDS / wall:.1f}), "
          f"launches {launches['song']} [{card}]")
    if pcm.shape != (total,) or pcm.dtype != np.int16:
        raise AssertionError(f"pcm {pcm.shape} {pcm.dtype}, expected ({total},) int16")
    if launches["song"] != expect_counts(svf_table=-(-total // CHUNK)):
        raise AssertionError(f"song launches {launches['song']}")
    if np.count_nonzero(pcm) < total // 2:
        raise AssertionError("the song render is mostly silent")
    t = time.perf_counter()
    perf = song.build_performance(total)
    plan_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    mix = render_performance(perf, total, CHUNK, device="cuda")
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    print(f"song: plan {plan_s:.3f}s, device render {render_s:.3f}s, "
          f"RTF {song.NUM_SECONDS / render_s:.1f} (render only) [{card}]")
    if not bool(torch.isfinite(mix).all()):
        raise AssertionError("non-finite samples in the song")
    if not np.array_equal(mixdown_s16(mix[0], song.MIX_VOLUME).cpu().numpy(), pcm):
        raise AssertionError("two renders of the song differ")
    gold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "song_golden_jax.npz"))
    if int(gold["total"]) != total or int(gold["chunk_size"]) != CHUNK:
        raise AssertionError("the song's golden file is for another song length")
    mix_np = mix.cpu().numpy()
    check_golden(gold["windows"], gold["offsets"], gold["chunk_rms"], mix_np[0], "song")
    with mock.patch.object(filters, "svf_filter_table", filters.svf_filter_table_ref):
        plain = render_performance(perf, total, CHUNK, device="cuda").cpu().numpy()
    check_plain(mix_np, plain, "song")
    del perf, mix, plain

    # 7-8. the sampler and poly_echo configs: (golden entry, config, seconds,
    # voices, the kernel each chunk launches and how often, frames of the
    # plain-path comparison or None)
    cgold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "configs_golden_jax.npz"))
    params = json.loads(str(cgold["params"]))
    if params["chunk_size"] != CHUNK:
        raise AssertionError("the configs' golden file is for another chunk size")
    plain_paths = {"sampler": (lookup, "table_lookup", lookup.table_lookup_ref),
                   "poly_echo": (filters, "svf_filter_table", filters.svf_filter_table_ref)}
    runs = [("sampler", "sampler", 10.0, None, "table_lookup", 2, "all"),
            ("poly_echo", "poly_echo", 30.0, 1024, "svf_table", 1, "all"),
            # the JAX package's capacity sizes (bench.py bench_poly); the
            # plain path's affine scan at 4096 voices fits one chunk
            ("poly_echo_4096", "poly_echo", 8.0, 4096, "svf_onepass", 1, CHUNK),
            ("poly_echo_16384", "poly_echo", 8.0, 16384, "svf_onepass", 1, None)]
    for name, config, seconds, voices, kname, per_chunk, plain_frames in runs:
        p = params[name]
        want = dict(seconds=seconds, sample_rate=44100.0)
        if config == "sampler":
            want.update(speed=1.0, distort=True, fake_sample_rate=6000.0)
            if seconds != configs.DEFAULT_SECONDS[config]:
                raise AssertionError("the sampler's default seconds changed")
            kw, build = {}, lambda: configs.build_sampler_performance()
        else:
            want.update(num_voices=voices, main_delay=15000, seed=0)
            kw = dict(voices=voices)
            build = lambda: configs.build_poly_echo_performance(num_voices=voices,
                                                                seconds=seconds)
        if any(p[k] != v for k, v in want.items()):
            raise AssertionError(f"the {name} golden was made for {p}, not {want}")
        total = int(seconds * configs.SAMPLE_RATE)
        channels = 1 if config == "sampler" else 2
        expect = expect_counts(**{kname: per_chunk * -(-total // CHUNK)})
        reset_counts(svf_cuda, lookup, fm)
        t = time.perf_counter()
        pcm = configs.render_config_s16(config, seconds, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[name] = counts(svf_cuda, lookup, fm)
        print(f"{name}: render_config_s16({config!r}, {seconds}, device='cuda'"
              f"{''.join(f', {k}={v}' for k, v in kw.items())}): {pcm.shape} in "
              f"{wall:.3f}s end to end (RTF {seconds / wall:.1f}), "
              f"launches {launches[name]} [{card}]")
        if pcm.shape != (channels, total) or pcm.dtype != np.int16:
            raise AssertionError(f"{name}: pcm {pcm.shape} {pcm.dtype}")
        if launches[name] != expect:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {expect}")
        if np.count_nonzero(pcm) < pcm.size // 2:
            raise AssertionError(f"the {name} render is mostly silent")
        t = time.perf_counter()
        perf, _ = build()
        plan_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        audio = render_performance(perf, total, CHUNK, device="cuda")
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name}: plan {plan_s:.3f}s, device render {render_s:.3f}s, "
              f"RTF {seconds / render_s:.1f} (render only), peak device memory "
              f"{peak_gib:.2f} GiB [{card}]")
        if not peak_gib < 64.0:
            raise AssertionError(f"{name}: peak device memory {peak_gib:.2f} GiB")
        if not bool(torch.isfinite(audio).all()):
            raise AssertionError(f"non-finite samples in the {name} render")
        if not np.array_equal(mixdown_s16(audio, configs.MIX_VOLUME).cpu().numpy(), pcm):
            raise AssertionError(f"two renders of {name} differ")
        audio_np = audio.cpu().numpy()
        del audio
        check_golden(cgold[f"{name}_windows"], cgold[f"{name}_offsets"],
                     cgold[f"{name}_chunk_rms"], audio_np, name)
        if plain_frames is not None:
            frames = total if plain_frames == "all" else plain_frames
            mod, attr, ref = plain_paths[config]
            reset_counts(svf_cuda, lookup, fm)
            with mock.patch.object(mod, attr, ref):
                plain = render_performance(perf, frames, CHUNK, device="cuda").cpu().numpy()
            if any(counts(svf_cuda, lookup, fm).values()):
                raise AssertionError(f"{name}: the plain path launched a kernel")
            check_plain(audio_np[:, :frames], plain, f"{name} ({frames} frames)")
            del plain
        del perf

    # 9. the examples
    run_examples(examples, filters, fm, lookup, svf_cuda, card, launches)

    # 10. nothing of JAX
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zang_tpu"))
    if bad:
        raise AssertionError(f"modules of jax or zang_tpu were imported: {bad}")

    def kernel_row(name, source, replaces, errs, times, main_shape):
        """One kernel's entry: the main shape's numbers at the top level,
        every shape's under "shapes", the launches of each main path."""
        by_path = {path: c[name] for path, c in launches.items() if c[name]}
        return {"name": name, "route": "cuda", "source": f"zang_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "max_abs_err": max(errs.values()), **times[main_shape],
                "launches_by_path": by_path,
                "shapes": {k: {"max_abs_err": errs.get(k), **times.get(k, {})}
                           for k in {**errs, **times}}}

    rows = [
        kernel_row("svf_table", "svf_table.cu", "zang_tpu/ops/pallas_svf.py:355", svf_err,
                   svf_t, "song"),
        kernel_row("svf_dense", "svf_dense.cu", "zang_tpu/ops/pallas_svf.py:187",
                   dense_err, dense_t, "play"),
        kernel_row("svf_onepass", "svf_onepass.cu", "zang_tpu/ops/pallas_svf.py:650",
                   onepass_err, onepass_t, "v16384"),
        kernel_row("table_lookup", "table_lookup.cu", "zang_tpu/ops/pallas_lookup.py:64",
                   {"sampler": lk_err}, {"sampler": lk_t}, "sampler"),
        kernel_row("fm_feedback", "fm_feedback.cu", "zang_tpu/ops/pallas_fm.py:64",
                   fm_err, fm_t, "fmsynth"),
    ]
    for r in rows:
        if not r["launches"]:
            raise AssertionError(f"{r['name']} was launched on no main path")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
