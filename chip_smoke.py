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
     a state chain across two calls, poly_echo's shape (1024 voices), the
     polyphony examples' (39 and 3 voices, 16384 frames in 32 tiles) and
     poly_echo's shape with the slot count of its 1024-voice render's
     tables (counted from its plan) and every sample active, as a render
     chunk is, a 262,144-frame chunk (two rounds of the cluster) and a
     chunk of 35 tiles (4 windows of 4480 frames); rms < -120 dBFS, end
     states within 1e-5; each case's device time (torch.profiler) beside
     its bound; the song's and poly_echo's shapes also per call (CUDA
     events) beside the plain version, and the song's beside K1's latency
     floor (an estimate from its dependent chain, svf_chain_floor_us,
     printed only). At the song's, the polyphony, the ragged, the long and
     the 35-tile shapes K1 is also held bit for bit to svf_table_emulated,
     its seams composed in torch
  4. K4, the table-lookup kernel: its two-tap entry (sampler_taps, both of
     the sampler's taps of a chunk in one launch) against sampler_taps_ref
     on the card, bit for bit: the sampler config's shape (looped, indices
     wrapping both ways), the sampler example's, a one-shot case with
     out-of-range indices and the 262,144-entry table; and the generic
     entry (table_lookup) against table_lookup_ref: the sampler's shape,
     the example's (idx 32 x 512), the largest table, one-shot edges. Both
     timed as K1, beside the plain version; the two-tap entry, looped and
     one shot, also beside the library call (one torch.take on indices
     stacked, wrapped or clipped and made int64 beforehand; one shot times
     a sel made beforehand), beside the fewest PyTorch calls that compute
     its function from its own inputs (the yardstick, which it must not
     lose to) and beside the two-launch path it replaced, with the host's
     microseconds a call
  5. K2, the dense-cut SVF kernel, against svf_filter_ref on the card:
     the play example's shape (V=1, n=16384, scalar cutoff, mask), the
     stereo example's (V=2, [2, 1] cutoff, no mask, resonance 0.4), the
     detuned example's two calls (V=2, scalar cutoff: 4 Hz, resonance 0, no
     mask; 7040 Hz with a mask), a ragged n with a [V, 1] cutoff, a state
     chain across two calls and V=1024, n=65536 with a dense cutoff and
     mask; rms < -120 dBFS, end states within 1e-5; at the play, stereo,
     detuned and ragged shapes also bit for bit against svf_dense_emulated,
     its seams composed in torch; timed as K1 (per call at the play and
     V=1024 shapes, device time at each example's), with its latency floor
     at play's shape (svf_chain_floor_us, printed only)
  6. K5, the FM feedback kernel, against fm_feedback_ref on the card, bit
     for bit in outputs and end states, at feedback pi/4 and waveforms 0-3:
     the fmsynth example's shape (V=8, n=16384), V=1024 x 16384 (beyond the
     TPU kernel's 128 lanes) and a ragged V=3 x 777; at the fmsynth shape
     also with feedback a voice and the waveform as tensors on the card.
     Its serial-chain floor is estimated by zang_tpu_torch/tools/chain_floor.py
  6b. K3, the one-pass table-cut SVF kernel for large voice counts, against
     svf_onepass_table_ref (the sequential loop) on the card, bit for bit:
     through the router at V=4096, n=2048 with active_from inside the
     chunk, a ragged V=5000 x 1000 with time tiles of 125 frames and four
     slots written over its input, a state chain across two calls, and the
     main path's V=16384 x 65536 written over its input; the router sends
     five slots a tile to K1 instead (V=4096, held to
     svf_filter_table_ref; one K1 launch, no K3), and at V=16384 x 65536
     with donate_x the peak device memory of that call is read;
     against K1 and K1's plain version at V=4096 (rms < -120 dBFS, end
     states within 1e-5); timed beside K1 called by name at 1024, 4096 and
     16384 voices x 65536 frames
  7. the main paths, each with every kernel's launch count set to 0 just
     before it and read just after:
       song       the full 385 s Bach Toccata, render_song_s16(device="cuda"):
                  282 K1 launches
       sampler    10 s, render_config_s16("sampler", device="cuda"):
                  7 K4 launches (both taps in one)
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
     sampler 17 K4, song 15 K1, stereo 18 K2, detuned 30 K2 (two a chunk),
     every other count 0), against the JAX
     golden windows and against the card's plain-path render (every
     router patched to its plain version by name; fmsynth at 2 s there,
     since the plain FM loop is a Python loop over samples, and bit for
     bit: K5 is the plain loop's bits). detuned is
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
# K1's and K2's latency floor, an estimate: the dependent f32 operations of
# one SVF step (svf_scan.cuh step: 11 from the state in to the state out),
# each at an assumed 4 cycles, as zang_tpu_torch/tools/chain_floor.py
# assumes for K5 and K3
SVF_STEP_CHAIN = 11
CYCLES_PER_DEPENDENT_OP = 4
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


def svf_chain_floor_us(cluster, mhz):
    """The latency floor of K1 and K2 in microseconds at `mhz`, from the
    dependent chain of their windowed body (csrc/svf_window.cuh) in a
    cluster of `cluster` blocks: a run of 16 frames stepped twice (phase A's
    zero state, phase B), two Kogge-Stone scans of 32 maps (warps, then
    the block's warps: 5 levels of a 3-deep compose each), the earlier
    windows' maps applied one after another (cluster - 1 applies, 3 deep)
    and the warp's and the run's start (two applies). Shuffle, barrier and
    memory latencies are not counted."""
    ops = 2 * 16 * SVF_STEP_CHAIN + 2 * 5 * 3 + (cluster - 1) * 3 + 2 * 3
    return ops * CYCLES_PER_DEPENDENT_OP / mhz


def svf_case(rng, V, n, nt, S, t0, device, always_active=False):
    """Random K1 inputs in the tiled table format, with active_from (None
    with always_active). From 2^27 samples on, x is drawn on the device
    (seeded from rng)."""
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
            None if always_active else to(af, torch.int32))


def svf_label(label, args):
    V, n = args[2].shape
    _, nt, S = args[4].shape
    return f"{label}: V={V} n={n} nt={nt} S={S}"


def svf_table_bytes_ops(args):
    """x read, out written, the tables (tb, cutv), active_from, l0/b0 in
    and l/b out, each once; the SVF's operations on every sample."""
    V, n = args[2].shape
    _, nt, S = args[4].shape
    af = 0 if args[8] is None else V
    return 4 * (2 * V * n + 2 * V * nt * S + af + 4 * V), SVF_OPS_PER_SAMPLE * V * n


def render_slots(configs, voices, seconds):
    """The slot count of the tables that K1 gets in poly_echo's render at
    `voices` x `seconds`: the NiceInstrument's phase program, as
    Performance.chunk_xs cuts it into chunks."""
    from zang_tpu_torch.ops.segprog import chunkify_tiled

    perf, total = configs.build_poly_echo_performance(num_voices=voices, seconds=seconds)
    n_chunks = -(-total // CHUNK)
    return max(chunkify_tiled(p["phase"], CHUNK, n_chunks, total)["tb"].shape[-1]
               for p in perf.programs if isinstance(p, dict) and "phase" in p)


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
    and 16384 voices x 65536 frames; and the router's K1 branch for five
    slots a tile. Returns (errs, times, k1_times)
    by shape, errs["router S=5"] that K1 launch's; the V=16384 entry
    carries the plain loop's one timed run."""
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
    # five slots a tile: the router takes K1 (svf_table_route), which returns
    # its own tensor even with donate_x
    a = svf_case(rng, 4096, 2048, 128, 5, 1024, dev)
    x_in = a[2].clone()
    before = svf_cuda.svf_onepass_launches, svf_cuda.svf_table_launches
    errs["router S=5"] = check_svf(svf_label("router, 5 slots", a),
                                   lambda *args: filters.svf_filter_table(*args,
                                                                          donate_x=True),
                                   filters.svf_filter_table_ref, a)
    if (svf_cuda.svf_onepass_launches, svf_cuda.svf_table_launches) != \
            (before[0], before[1] + 1) or not torch.equal(a[2], x_in):
        raise AssertionError("svf_filter_table did not take K1 alone at V=4096, S=5, or "
                             "wrote over x")
    a = svf_case(rng, 16384, CHUNK, 128, 5, 3 * CHUNK, dev)
    torch.cuda.synchronize()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    before = svf_cuda.svf_onepass_launches, svf_cuda.svf_table_launches
    got = filters.svf_filter_table(*a, donate_x=True)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if (svf_cuda.svf_onepass_launches, svf_cuda.svf_table_launches) != \
            (before[0], before[1] + 1):
        raise AssertionError("svf_filter_table did not take K1 alone at V=16384, S=5")
    print(f"  router, 5 slots, V=16384 x {CHUNK} with donate_x: K1 (no K3 launch), "
          f"{'finite' if bool(torch.isfinite(got[2]).all()) else 'NOT finite'}; peak device "
          f"memory {peak_gib:.2f} GiB, {peak_gib - base_gib:.2f} GiB above the inputs "
          f"[{card}]")
    if not bool(torch.isfinite(got[2]).all()) or not peak_gib < 64.0:
        raise AssertionError("the K1 route at 16384 voices failed")
    del a, got, x_in
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


def taps_case(rng, N, n, device, lo, hi):
    """The sampler's two index arrays of a chunk: idx_a from [lo, hi),
    idx_b = idx_a + 1, each [1, n]; a table of N samples."""
    import torch

    table = rng.standard_normal(N).astype("float32")
    ia = rng.integers(lo, hi, (1, n)).astype("int32")
    return tuple(torch.from_numpy(a).to(device) for a in (ia, ia + 1, table))


def check_taps(lookup, case, loop, label):
    """The two-tap entry against its plain version, bit for bit."""
    import torch

    ia, ib, table = case
    N = table.shape[0]
    got = lookup.sampler_taps(ia, ib, table, N, loop)
    want = lookup.sampler_taps_ref(ia, ib, table, N, loop)
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    err = float((got - want).abs().max())
    print(f"  {label}: 2 x {tuple(ia.shape)}, N={N}, {'looped' if loop else 'one shot'}: "
          f"{'bit-exact' if exact else 'DIFFERS'}, max |diff| {err:.3e}, "
          f"{int(((ia < 0) | (ia >= N)).sum())} of tap a outside [0, N)")
    if not exact:
        raise AssertionError(f"{label}: sampler_taps disagrees with sampler_taps_ref")
    return err


def host_us(fn, reps):
    """The host's microseconds a call: the enqueue, no synchronisation
    inside the loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


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


def check_fm(fm, c, waveform, label, feedback=FB):
    """K5 (through the fm_feedback router) vs fm_feedback_ref, bit for bit in
    the outputs and the end states. Returns max |out diff| (0.0)."""
    import torch

    args = (c["base"], feedback, waveform, c["fb1"], c["fb2"])
    ok, f1k, f2k = fm.fm_feedback(*args)
    orf, f1r, f2r = fm.fm_feedback_ref(*args)
    torch.cuda.synchronize()
    same = torch.equal(ok, orf) and torch.equal(f1k, f1r) and torch.equal(f2k, f2r)
    err = float((ok - orf).abs().max())
    V, n = ok.shape
    print(f"  {label}: V={V} n={n} waveform {int(waveform)}: "
          f"{'bit-exact' if same else 'NOT bit-exact'}, max |diff| {err:.3e}, end state "
          f"|diff| {max(float((f1k - f1r).abs().max()), float((f2k - f2r).abs().max())):.3e}")
    if not same:
        raise AssertionError(f"{label}: the FM kernel is not fm_feedback_ref bit for bit")
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


# the kernel each example launches once a render chunk (detuned's twice: its
# two filters); the other examples launch none
EXAMPLE_KERNEL = {"play": ("svf_dense", 1), "fmsynth": ("fm_feedback", 1),
                  "polyphony": ("svf_table", 1), "polyphony2": ("svf_table", 1),
                  "sampler": ("table_lookup", 1), "song": ("svf_table", 1),
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
                           (lookup, "table_lookup", lookup.table_lookup_ref),
                           (lookup, "sampler_taps", lookup.sampler_taps_ref)):
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
        if name == "fmsynth" and not np.array_equal(ours, plain):
            raise AssertionError("fmsynth: the render is not the plain path's bits")


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
        err = check_svf(svf_label(label, a), filters.svf_filter_table,
                        filters.svf_filter_table_ref, a)
        k1_device(label, a)
        return err

    def k1_device(label, a):
        """K1's device time at one case, beside its bound."""
        bound_ms, bound_by = bound(*svf_table_bytes_ops(a))
        dev_ms = device_ms(lambda: filters.svf_filter_table(*a), "svf_table_kernel",
                           100 if a[2].shape[0] < 256 else 20)
        print(f"    device {dev_ms:.4f} ms a launch, bound {bound_ms * 1e3:.3f} us "
              f"({bound_by}) [{card}]")
        k1_dev[label] = dict(device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by)

    def k1_emulated(label, a):
        """K1 against its seams composed in torch: bit for bit."""
        got, want = filters.svf_filter_table(*a), svf_cuda.svf_table_emulated(*a)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"  {svf_label(label, a)} vs svf_table_emulated: "
              f"{'bit-exact' if same else 'NOT bit-exact'}")
        if not same:
            raise AssertionError(f"{label}: K1 is not its seams composed in torch")

    def k2(label, a):
        return check_svf(dense_label(label, a), filters.svf_filter, filters.svf_filter_ref, a)

    def k2_emulated(label, a):
        """K2 against its seams composed in torch: bit for bit."""
        got, want = filters.svf_filter(*a), svf_cuda.svf_dense_emulated(*a)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"  {dense_label(label, a)} vs svf_dense_emulated: "
              f"{'bit-exact' if same else 'NOT bit-exact'}")
        if not same:
            raise AssertionError(f"{label}: K2 is not its seams composed in torch")

    def k2_device(label, a):
        """K2's device time at one case, beside its bound."""
        bound_ms, bound_by = bound(*dense_bytes_ops(a))
        dev_ms = device_ms(lambda: filters.svf_filter(*a), "svf_dense_kernel", 100)
        print(f"    {label}: device {dev_ms:.4f} ms a launch, bound {bound_ms * 1e3:.3f} us "
              f"({bound_by}) [{card}]")
        return dict(device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by)

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
    t = time.perf_counter()
    s_render = render_slots(configs, 1024, 30.0)
    print(f"poly_echo at 1024 voices x 30 s: K1's tables have {s_render} slots a tile "
          f"(counted from its plan in {time.perf_counter() - t:.1f}s)")
    print(f"K1 svf_table vs svf_filter_table_ref (rms < {TOL_DB} dBFS, "
          f"end state |diff| < {TOL_STATE}):")
    k1_dev = {}
    song_case = svf_case(rng, 14, CHUNK, 128, 2, 7 * CHUNK, dev)
    poly_case = svf_case(rng, 1024, CHUNK, 128, 2, 5 * CHUNK, dev)
    ragged_case = svf_case(rng, 3, 2048, 4, 3, 4096, dev)
    ex_chunk = examples.DEFAULT_CHUNK
    polyphony_case = svf_case(rng, 39, ex_chunk, 32, 2, 3 * ex_chunk, dev)
    svf_err = {
        "song": max(k1("song shape", song_case), k1("ragged shape", ragged_case)),
        "poly_echo": k1("poly_echo shape", poly_case),
        # the polyphony examples' chunk: 32 tiles of 512 frames
        "polyphony": max(k1("polyphony shape", polyphony_case),
                         k1("polyphony2 shape", svf_case(rng, 3, ex_chunk, 32, 3,
                                                         5 * ex_chunk, dev))),
        # the render's own slot count, every sample active
        "poly_echo render slots": k1("poly_echo render slots",
                                     svf_case(rng, 1024, CHUNK, 128, s_render, 5 * CHUNK,
                                              dev, always_active=True))}
    # render_wav song --chunk 262144: the cluster walks 16 windows in 2 rounds;
    # a 35-tile chunk: 4 windows of 4480 frames
    long_case = svf_case(rng, 14, 4 * CHUNK, 512, 2, 4 * CHUNK, dev)
    windows_case = svf_case(rng, 3, 35 * 512, 35, 3, CHUNK, dev)
    svf_err["long chunk"] = max(k1("long chunk", long_case),
                                k1("4480-frame windows", windows_case))
    for label, a in (("song shape", song_case), ("polyphony shape", polyphony_case),
                     ("ragged shape", ragged_case), ("long chunk", long_case),
                     ("4480-frame windows", windows_case)):
        k1_emulated(label, a)
    del long_case
    V, n, nt, t0 = 4, 4096, 8, 1024
    chain = svf_case(rng, V, 2 * n, 2 * nt, 3, t0, dev)
    check_svf_chain(f"chained 2 x {n}", filters.svf_filter_table,
                    filters.svf_filter_table_ref, chain,
                    lambda k, l, b: (l, b, chain[2][:, k * n:(k + 1) * n].contiguous(),
                                     "low_pass",
                                     chain[4][:, k * nt:(k + 1) * nt].contiguous(),
                                     chain[5][:, k * nt:(k + 1) * nt].contiguous(), 0.7,
                                     t0 + k * n, chain[8]))
    k1_device("chained half", (chain[0], chain[1], chain[2][:, :n].contiguous(), "low_pass",
                               chain[4][:, :nt].contiguous(), chain[5][:, :nt].contiguous(),
                               0.7, t0, chain[8]))
    svf_t = {"song": k1_time("song", song_case, 100, 10),
             "poly_echo": k1_time("poly_echo", poly_case, 20, 3)}
    mhz = float(smi("clocks.max.sm").split()[0])
    cluster = svf_cuda.svf_table_geometry(*song_case[2].shape, *song_case[4].shape[1:]).cluster
    # an estimate, printed only: the kernels line carries measured times
    print(f"  K1's latency floor at the song shape, an estimate: "
          f"{svf_chain_floor_us(cluster, mhz):.3f} us at {mhz:.0f} MHz (the dependent "
          f"chain at {CYCLES_PER_DEPENDENT_OP} cycles an operation), beside the bytes "
          f"bound {svf_t['song']['bound_ms'] * 1e3:.3f} us and the device time "
          f"{svf_t['song']['device_ms'] * 1e3:.1f} us [{card}]")
    for label in ("ragged shape", "polyphony shape", "polyphony2 shape",
                  "poly_echo render slots", "chained half", "long chunk", "4480-frame windows"):
        svf_t[label.replace(" shape", "")] = k1_dev[label]
    del poly_case

    # 4. K4 vs plain on the card: the two-tap entry, then the generic one
    print("K4 sampler_taps vs sampler_taps_ref and table_lookup vs table_lookup_ref "
          "(bit for bit):")
    n_drum = configs.SamplerInstrument().table.num_samples
    big = 128 * 2048
    sam_taps = taps_case(rng, n_drum, CHUNK, dev, -n_drum, 2 * n_drum)
    lk_err = {
        "sampler": max(
            check_taps(lookup, sam_taps, True, "sampler shape"),
            check_taps(lookup, taps_case(rng, n_drum, ex_chunk, dev, -n_drum, 2 * n_drum),
                       True, "sampler example shape"),
            check_taps(lookup, taps_case(rng, n_drum, CHUNK, dev, -n_drum // 4,
                                         n_drum + n_drum // 4), False, "one-shot edges"),
            check_taps(lookup, taps_case(rng, big, CHUNK, dev, -big, 2 * big), True,
                       "largest table"),
            check_taps(lookup, taps_case(rng, big, CHUNK, dev, -big // 4, big + big // 4),
                       False, "largest table, one shot")),
        "generic": max(
            check_lookup(lookup, lookup_case(rng, n_drum, CHUNK // 512, dev),
                         "generic, sampler shape"),
            check_lookup(lookup, lookup_case(rng, n_drum, ex_chunk // 512, dev),
                         "generic, sampler example shape"),
            check_lookup(lookup, lookup_case(rng, big, CHUNK // 512, dev),
                         "generic, largest table"),
            check_lookup(lookup, lookup_case(rng, n_drum, CHUNK // 512, dev, p_sel=0.5,
                                             out_of_range=True),
                         "generic, one-shot edges"))}
    ia, ib, table = sam_taps
    taps = {loop: (lambda loop=loop: lookup.sampler_taps(ia, ib, table, n_drum, loop))
            for loop in (True, False)}
    pair = torch.stack((ia, ib))
    # the library call, one torch.take, on indices stacked, wrapped (looped) or
    # clipped (one shot) and made int64 beforehand, untimed; one shot also
    # multiplies by a sel made beforehand
    wrapped = torch.remainder(pair, n_drum).long()
    clipped = torch.clamp(pair, 0, n_drum - 1).long()
    sel = ((pair >= 0) & (pair < n_drum)).to(torch.float32)
    library = {True: ("torch.take on the wrapped int64 indices",
                      lambda: torch.take(table, wrapped)),
               False: ("torch.take on the clipped int64 indices * sel",
                       lambda: torch.take(table, clipped) * sel)}
    # the yardstick: the fewest PyTorch calls that compute the same function
    # from the same inputs (the two int32 index arrays)
    def one_shot():
        p = torch.stack((ia, ib))
        return table[p.clamp(0, n_drum - 1)] * ((p >= 0) & (p < n_drum))

    yardstick = {True: lambda: table[torch.stack((ia, ib)) % n_drum], False: one_shot}
    # the two-launch path the sampler took before: a tap at a time, wrapped
    # and sel made in torch, then the one-tap entry
    ones = torch.ones(ia.shape, dtype=torch.float32, device=dev)
    per_tap = lambda: [lookup.table_lookup(torch.remainder(i, n_drum).to(torch.int32),
                                           torch.ones_like(ones), table) for i in (ia, ib)]
    for loop in (True, False):
        if not (torch.equal(taps[loop](), library[loop][1]())
                and torch.equal(taps[loop](), yardstick[loop]())):
            raise AssertionError("sampler_taps differs from torch.take")
    lk_t = {}
    for loop, key in ((True, "sampler"), (False, "one shot")):
        # both taps' indices read and outputs written, the table read; the
        # wrap and the product a sample
        lk_t[key] = timing(card, f"sampler taps, {'looped' if loop else 'one shot'}",
                           taps[loop],
                           lambda loop=loop: lookup.sampler_taps_ref(ia, ib, table, n_drum,
                                                                     loop),
                           "lookup_kernel", 16 * ia.numel() + 4 * table.numel(),
                           2 * ia.numel(), 500, 50, library=library[loop])
        y = [time_ms(yardstick[loop], 500) for _ in range(2)]
        h = [host_us(f, 500) for f in (taps[loop], library[loop][1], yardstick[loop])
             for _ in range(2)]
        lk_t[key].update(yardstick_ms=sum(y) / 2, host_us=(h[0] + h[1]) / 2,
                         library_host_us=(h[2] + h[3]) / 2, yardstick_host_us=(h[4] + h[5]) / 2)
        what = "table[stack % N]" if loop else "table[stack.clamp(0, N - 1)] * sel"
        print(f"  the same function from the same inputs, {what} [{card}]: "
              f"{y[0]:.4f} / {y[1]:.4f} ms; host a call: "
              f"sampler_taps {h[0]:.1f} / {h[1]:.1f} us, the library call {h[2]:.1f} / "
              f"{h[3]:.1f} us, the yardstick {h[4]:.1f} / {h[5]:.1f} us")
        if not lk_t[key]["ms"] <= lk_t[key]["yardstick_ms"]:
            raise AssertionError("sampler_taps is slower a call than the PyTorch calls for "
                                 "the same function from the same inputs")
        if lk_t[key]["ms"] > lk_t[key]["library_ms"]:
            print(f"  sampler_taps is slower a call than {library[loop][0]} (prepared "
                  f"indices): {lk_t[key]['ms'] * 1e3:.1f} against "
                  f"{lk_t[key]['library_ms'] * 1e3:.1f} us")
    p = [time_ms(per_tap, 500) for _ in range(2)]
    ph = [host_us(per_tap, 500) for _ in range(2)]
    lk_t["sampler"].update(per_tap_ms=sum(p) / 2, per_tap_host_us=sum(ph) / 2)
    print(f"  the two-launch path it replaced (a tap at a time: wrap, sel, table_lookup) "
          f"[{card}]: {p[0]:.4f} / {p[1]:.4f} ms, host {ph[0]:.1f} / {ph[1]:.1f} us a chunk")
    idx, sel1 = wrapped[0].to(torch.int32), ones
    lk_t["generic"] = timing(card, "generic lookup",
                             lambda: lookup.table_lookup(idx, sel1, table),
                             lambda: lookup.table_lookup_ref(idx, sel1, table),
                             "lookup_kernel", 12 * idx.numel() + 4 * table.numel(),
                             idx.numel(), 200, 50,
                             library=("torch.take(table, idx) * sel",
                                      lambda: torch.take(table, wrapped[0]) * sel1))

    # 5. K2 vs plain on the card
    print(f"K2 svf_dense vs svf_filter_ref (rms < {TOL_DB} dBFS, "
          f"end state |diff| < {TOL_STATE}):")
    play_case = dense_case(rng, 1, ex_chunk, "scalar", True, dev)
    wide_case = dense_case(rng, 1024, CHUNK, "dense", True, dev)
    ragged_dense = dense_case(rng, 3, 1000, "column", True, dev)
    # the stereo example: a [2, 1] cutoff, no mask, resonance 0.4
    stereo_case = dense_case(rng, 2, ex_chunk, "column", False, dev, res=0.4)
    # the detuned example's two calls a chunk: the 4 Hz warble lowpass
    # (resonance 0, no mask), then the 7040 Hz lowpass under the note mask
    warble_case = dense_case(rng, 2, ex_chunk, "scalar", False, dev, res=0.0,
                             scalar_cut=filters.cutoff_from_frequency(4.0, 48000.0))
    voice_case = dense_case(rng, 2, ex_chunk, "scalar", True, dev,
                            scalar_cut=filters.cutoff_from_frequency(7040.0, 48000.0))
    dense_err = {
        "play": max(k2("play shape", play_case),
                    k2("ragged n, [V, 1] cutoff", ragged_dense),
                    k2("dense cutoff, no mask", dense_case(rng, 2, 4096, "dense", False,
                                                           dev))),
        "stereo": k2("stereo shape", stereo_case),
        "detuned": max(k2("detuned warble shape", warble_case),
                       k2("detuned voice shape", voice_case)),
        "v1024": k2("V=1024 shape", wide_case)}
    for label, a in (("play shape", play_case), ("stereo shape", stereo_case),
                     ("detuned warble shape", warble_case),
                     ("detuned voice shape", voice_case), ("ragged shape", ragged_dense)):
        k2_emulated(label, a)
    chain = dense_case(rng, 4, 2 * n, "dense", True, dev)
    check_svf_chain(f"chained 2 x {n}", filters.svf_filter, filters.svf_filter_ref, chain,
                    lambda k, l, b: (l, b, chain[2][:, k * n:(k + 1) * n].contiguous(),
                                     "low_pass", chain[4][:, k * n:(k + 1) * n], 0.7,
                                     chain[6][:, k * n:(k + 1) * n]))
    dense_t = {"play": k2_time("play", play_case, 100, 10),
               "v1024": k2_time("V=1024", wide_case, 20, 2),
               "stereo": k2_device("stereo shape", stereo_case),
               "detuned": k2_device("detuned voice shape", voice_case),
               "detuned warble": k2_device("detuned warble shape", warble_case)}
    play_cluster = svf_cuda.svf_dense_geometry(*play_case[2].shape).cluster
    print(f"  K2's latency floor at the play shape, an estimate: "
          f"{svf_chain_floor_us(play_cluster, mhz):.3f} us at {mhz:.0f} MHz, beside the "
          f"bytes bound {dense_t['play']['bound_ms'] * 1e3:.3f} us and the device time "
          f"{dense_t['play']['device_ms'] * 1e3:.1f} us [{card}]")
    del wide_case, chain

    # 6. K5 vs plain on the card
    print("K5 fm_feedback vs fm_feedback_ref at feedback pi/4 (bit for bit):")
    fm_cases = {"fmsynth": fm_case(rng, 8, ex_chunk, dev),
                "v1024": fm_case(rng, 1024, ex_chunk, dev),  # beyond the TPU's 128 lanes
                "ragged": fm_case(rng, 3, 777, dev)}
    fm_err = {k: max(check_fm(fm, c, w, k) for w in range(4)) for k, c in fm_cases.items()}
    # the operands by pointer: feedback a voice, the waveform an int32 on the card
    c = fm_cases["fmsynth"]
    fb_voices = torch.full((8,), FB, dtype=torch.float32, device=dev)
    fb_voices[::2] = 0.5
    fm_err["by pointer"] = max(
        check_fm(fm, c, torch.tensor(w, dtype=torch.int32, device=dev),
                 "fmsynth, operands on the card", feedback=fb_voices) for w in range(4))
    fm_t = {}
    for k in ("fmsynth", "v1024"):
        c = fm_cases[k]
        V, n = c["base"].shape
        args = (c["base"], FB, 0, c["fb1"], c["fb2"])
        fm_t[k] = timing(card, f"{k}, V={V} n={n}", lambda a=args: fm.fm_feedback(*a),
                         lambda a=args: fm.fm_feedback_ref(*a), "fm_feedback_kernel",
                         *fm_bytes_ops(V, n), 20 if V < 1024 else 10, 1)
        print(f"  {fm_t[k]['device_ms'] * 1e6 / n:.2f} ns of device a step of the "
              f"{n}-step serial chain")
    del fm_cases

    # 6b. K3 vs its plain loop, K1 and K1's plain version on the card
    onepass_err, onepass_t, k1_by_name = run_onepass(card, dev, rng, filters, svf_cuda)
    svf_err["router S=5"] = onepass_err.pop("router S=5")  # a K1 launch
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
    plain_paths = {"sampler": (lookup, "sampler_taps", lookup.sampler_taps_ref),
                   "poly_echo": (filters, "svf_filter_table", filters.svf_filter_table_ref)}
    runs = [("sampler", "sampler", 10.0, None, "table_lookup", 1, "all"),
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
                   lk_err, lk_t, "sampler"),
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
