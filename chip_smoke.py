#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zang_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repo root, on a machine with CUDA, nvcc, g++ and torch. Phases,
each of which raises on failure:

  1. the card: nvidia-smi name and power limit, torch's device name
  2. build, all at once: the two CUDA kernels from zang_tpu_torch/csrc/
     (nvcc, one process per source) and the C++ host compiler (g++), into
     zang_tpu_torch/build/
  3. K1, the table-cut SVF kernel, against its plain torch version
     (svf_filter_table_ref) on the card: the song's shape, a ragged shape,
     a state chain across two calls and poly_echo's shape (1024 voices);
     rms < -120 dBFS, end states within 1e-5; timed with CUDA events
     (per call) and torch.profiler (the kernel's device time)
  4. K4, the table-lookup kernel, against table_lookup_ref on the card, bit
     for bit: the sampler's shape, the largest table, a one-shot case with
     zero sel and out-of-range indices; timed as K1, beside the plain
     version and torch.take(table, idx) * sel
  5. the main paths, each with every kernel's launch count set to 0 just
     before it and read just after:
       song       the full 385 s Bach Toccata, render_song_s16(device="cuda"):
                  282 K1 launches
       sampler    10 s, render_config_s16("sampler", device="cuda"):
                  14 K4 launches
       poly_echo  1024 voices x 30 s stereo, render_config_s16("poly_echo",
                  device="cuda"): 21 K1 launches
     then each again in its two timed steps (plan, device render)
  6. fidelity without JAX: each render against the JAX package's golden
     windows (zang_tpu_torch/data/*_golden_jax.npz, < -90 dBFS RMS, every
     channel) and against the card's own plain-path render
  7. no module of jax or of zang_tpu was imported

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


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel_name in e.key]
    n = sum(e.count for e in rows)
    if n != reps:
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


# ---------------------------------------------------------------------------
# K1


def svf_case(rng, V, n, nt, S, t0, device):
    """Random SVF inputs in the tiled table format, with active_from."""
    import numpy as np
    import torch

    T = n // nt
    tb = np.empty((V, nt, S), np.int64)
    tb[:, :, 0] = -(2 ** 31)
    tb[:, :, 1:] = (np.sort(rng.integers(0, T, (V, nt, S - 1)), axis=-1)
                    + t0 + np.arange(nt)[None, :, None] * T)
    cutv = rng.uniform(0.05, 0.9, (V, nt, S)).astype(np.float32)
    af = rng.integers(t0, t0 + n // 2, V)
    x = (rng.standard_normal((V, n)) * 0.3).astype(np.float32)
    l0 = (rng.standard_normal(V) * 0.1).astype(np.float32)
    b0 = (rng.standard_normal(V) * 0.1).astype(np.float32)
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return dict(l0=to(l0, torch.float32), b0=to(b0, torch.float32),
                x=to(x, torch.float32), tb=to(tb, torch.int32),
                cutv=to(cutv, torch.float32), af=to(af, torch.int32), t0=t0)


def svf_args(c):
    return (c["l0"], c["b0"], c["x"], "low_pass", c["tb"], c["cutv"], 0.7, c["t0"],
            c["af"])


def check_kernel(filters, c, label):
    """Kernel vs plain on one case; returns max |out diff|."""
    import torch

    lk, bk, ok = filters.svf_filter_table(*svf_args(c))
    lr, br, orf = filters.svf_filter_table_ref(*svf_args(c))
    torch.cuda.synchronize()
    db = rms_db(ok.cpu(), orf.cpu())
    dstate = max(float((lk - lr).abs().max()), float((bk - br).abs().max()))
    err = float((ok - orf).abs().max())
    print(f"  {label}: V={c['x'].shape[0]} n={c['x'].shape[1]} "
          f"nt={c['tb'].shape[1]} S={c['tb'].shape[2]}: rms {db:.1f} dBFS, "
          f"max |diff| {err:.3e}, end state |diff| {dstate:.3e}")
    if not (db < TOL_DB and dstate < TOL_STATE):
        raise AssertionError(f"{label}: kernel disagrees with svf_filter_table_ref")
    return err


def check_chain(filters, rng, device):
    """Two chained kernel calls against one plain call over both halves."""
    import torch

    V, n, nt, S, t0 = 4, 4096, 8, 3, 1024
    c = svf_case(rng, V, 2 * n, 2 * nt, S, t0, device)
    lr, br, full = filters.svf_filter_table_ref(*svf_args(c))
    l, b, halves = c["l0"], c["b0"], []
    for k in range(2):
        l, b, out = filters.svf_filter_table(
            l, b, c["x"][:, k * n:(k + 1) * n].contiguous(), "low_pass",
            c["tb"][:, k * nt:(k + 1) * nt].contiguous(),
            c["cutv"][:, k * nt:(k + 1) * nt].contiguous(), 0.7, t0 + k * n, c["af"])
        halves.append(out)
    torch.cuda.synchronize()
    db = rms_db(torch.cat(halves, dim=1).cpu(), full.cpu())
    dstate = max(float((l - lr).abs().max()), float((b - br).abs().max()))
    print(f"  chained 2 x {n}: rms {db:.1f} dBFS, end state |diff| {dstate:.3e}")
    if not (db < TOL_DB and dstate < TOL_STATE):
        raise AssertionError("chained kernel calls disagree with one plain call")


def svf_timing(filters, c, card, label, reps_k, reps_p):
    """Kernel and plain times at one shape, and the kernel's bound."""
    V, n = c["x"].shape
    _, nt, S = c["tb"].shape
    ms, plain_ms, r = time_pair(lambda: filters.svf_filter_table(*svf_args(c)),
                                lambda: filters.svf_filter_table_ref(*svf_args(c)),
                                reps_k, reps_p)
    # x read, out written, the tables (tb, cutv), active_from, l0/b0 in and
    # l/b out, each once
    n_bytes = 4 * (2 * V * n + 2 * V * nt * S + V + 4 * V)
    bound_ms, bound_by = bound(n_bytes, SVF_OPS_PER_SAMPLE * V * n)
    dev_ms = device_ms(lambda: filters.svf_filter_table(*svf_args(c)), "svf_table_kernel",
                       reps_k)
    print(f"  time at the {label} shape [{card}]: kernel {r[0]:.4f} / {r[1]:.4f} ms "
          f"(device {dev_ms:.4f} ms), plain {r[2]:.4f} / {r[3]:.4f} ms; bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {n_bytes} B)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, device_ms=dev_ms)


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
# main paths


def counts(svf_cuda, lookup):
    return {"svf_table": svf_cuda.svf_table_launches,
            "table_lookup": lookup.table_lookup_launches}


def reset_counts(svf_cuda, lookup):
    svf_cuda.svf_table_launches = 0
    lookup.table_lookup_launches = 0


def check_golden(gold_windows, offsets, chunk_rms_gold, audio, label):
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
        np.sqrt(np.mean(audio[..., i * CHUNK:(i + 1) * CHUNK].astype(np.float64) ** 2,
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
    from zang_tpu_torch.host import configs, song
    from zang_tpu_torch.ops import filters, lookup, svf_cuda

    # 1. the card
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    dev = torch.device("cuda")

    # 2. build: one compiler process per source, all started together
    t = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(fn) for name, fn in (
            ("svf_table.cu", svf_cuda.build), ("table_lookup.cu", lookup.build),
            ("zang_host.cpp", native.build))}
        secs = {name: job.result() for name, job in jobs.items()}
    print(f"build: {', '.join(f'{k} {v:.2f}s' for k, v in secs.items())} "
          f"(compiler time; {time.perf_counter() - t:.2f}s wall, in parallel)")

    # 3. K1 vs plain on the card
    rng = np.random.default_rng(20261016)
    print(f"K1 svf_table vs svf_filter_table_ref (rms < {TOL_DB} dBFS, "
          f"end state |diff| < {TOL_STATE}):")
    song_case = svf_case(rng, 14, CHUNK, 128, 2, 7 * CHUNK, dev)
    poly_case = svf_case(rng, 1024, CHUNK, 128, 2, 5 * CHUNK, dev)
    svf_err = {"song": check_kernel(filters, song_case, "song shape"),
               "poly_echo": check_kernel(filters, poly_case, "poly_echo shape")}
    svf_err["song"] = max(svf_err["song"], check_kernel(
        filters, svf_case(rng, 3, 2048, 4, 3, 4096, dev), "ragged shape"))
    check_chain(filters, rng, dev)
    svf_t = {"song": svf_timing(filters, song_case, card, "song", 100, 10),
             "poly_echo": svf_timing(filters, poly_case, card, "poly_echo", 20, 3)}
    del poly_case

    # 4. K4 vs plain on the card
    print("K4 table_lookup vs table_lookup_ref (bit for bit):")
    n_drum = configs.SamplerInstrument().table.num_samples
    sam_case = lookup_case(rng, n_drum, CHUNK // 512, dev)
    lk_err = max(
        check_lookup(lookup, sam_case, "sampler shape"),
        check_lookup(lookup, lookup_case(rng, 128 * 2048, CHUNK // 512, dev),
                     "largest table"),
        check_lookup(lookup, lookup_case(rng, n_drum, CHUNK // 512, dev, p_sel=0.5,
                                         out_of_range=True), "one-shot edges"))
    idx, sel, table = sam_case
    idx_long = idx.long()  # torch.take wants int64 indices
    lk_ms, lk_plain_ms, r = time_pair(lambda: lookup.table_lookup(idx, sel, table),
                                      lambda: lookup.table_lookup_ref(idx, sel, table),
                                      200, 50)
    lib_a = time_ms(lambda: torch.take(table, idx_long) * sel, 200)
    lib_b = time_ms(lambda: torch.take(table, idx_long) * sel, 200)
    lk_bytes = 12 * idx.numel() + 4 * table.numel()  # idx, sel in; out; the table
    lk_bound_ms, lk_bound_by = bound(lk_bytes, idx.numel())
    lk_dev_ms = device_ms(lambda: lookup.table_lookup(idx, sel, table),
                          "table_lookup_kernel", 200)
    print(f"  time at the sampler shape [{card}]: kernel {r[0]:.4f} / {r[1]:.4f} ms "
          f"(device {lk_dev_ms:.4f} ms), "
          f"plain {r[2]:.4f} / {r[3]:.4f} ms, torch.take(table, idx) * sel "
          f"{lib_a:.4f} / {lib_b:.4f} ms; bound {lk_bound_ms * 1e3:.3f} us "
          f"({lk_bound_by}, {lk_bytes} B)")

    launches = {}

    # 5-6. the song
    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    reset_counts(svf_cuda, lookup)
    t = time.perf_counter()
    pcm = song.render_song_s16(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches["song"] = counts(svf_cuda, lookup)
    print(f"song: render_song_s16(device='cuda'): {pcm.shape[0]} frames in "
          f"{wall:.3f}s end to end (RTF {song.NUM_SECONDS / wall:.1f}), "
          f"launches {launches['song']} [{card}]")
    if pcm.shape != (total,) or pcm.dtype != np.int16:
        raise AssertionError(f"pcm {pcm.shape} {pcm.dtype}, expected ({total},) int16")
    if launches["song"] != {"svf_table": -(-total // CHUNK), "table_lookup": 0}:
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

    # 5-6. the sampler and poly_echo configs
    cgold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "configs_golden_jax.npz"))
    params = json.loads(str(cgold["params"]))
    if params["chunk_size"] != CHUNK:
        raise AssertionError("the configs' golden file is for another chunk size")
    expect = {"sampler": {"table_lookup": 2 * -(-int(10.0 * 44100) // CHUNK),
                          "svf_table": 0},
              "poly_echo": {"svf_table": -(-int(30.0 * 44100) // CHUNK),
                            "table_lookup": 0}}
    make_perf = {
        "sampler": lambda: configs.build_sampler_performance(),
        "poly_echo": lambda: configs.build_poly_echo_performance(),
    }
    plain_paths = {"sampler": (lookup, "table_lookup", lookup.table_lookup_ref),
                   "poly_echo": (filters, "svf_filter_table", filters.svf_filter_table_ref)}
    for name in ("sampler", "poly_echo"):
        p = params[name]
        want = {"sampler": dict(seconds=10.0, sample_rate=44100.0, speed=1.0, distort=True,
                                fake_sample_rate=6000.0),
                "poly_echo": dict(num_voices=1024, seconds=30.0, sample_rate=44100.0,
                                  main_delay=15000, seed=0)}[name]
        if any(p[k] != v for k, v in want.items()):
            raise AssertionError(f"the {name} golden was made for {p}, not {want}")
        seconds = configs.DEFAULT_SECONDS[name]
        total = int(seconds * configs.SAMPLE_RATE)
        channels = {"sampler": 1, "poly_echo": 2}[name]
        reset_counts(svf_cuda, lookup)
        t = time.perf_counter()
        pcm = configs.render_config_s16(name, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[name] = counts(svf_cuda, lookup)
        print(f"{name}: render_config_s16({name!r}, device='cuda'): {pcm.shape} in "
              f"{wall:.3f}s end to end (RTF {seconds / wall:.1f}), "
              f"launches {launches[name]} [{card}]")
        if pcm.shape != (channels, total) or pcm.dtype != np.int16:
            raise AssertionError(f"{name}: pcm {pcm.shape} {pcm.dtype}")
        if launches[name] != expect[name]:
            raise AssertionError(f"{name}: launches {launches[name]}, expected "
                                 f"{expect[name]}")
        if np.count_nonzero(pcm) < pcm.size // 2:
            raise AssertionError(f"the {name} render is mostly silent")
        t = time.perf_counter()
        perf, _ = make_perf[name]()
        plan_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        audio = render_performance(perf, total, CHUNK, device="cuda")
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t
        print(f"{name}: plan {plan_s:.3f}s, device render {render_s:.3f}s, "
              f"RTF {seconds / render_s:.1f} (render only), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
        if not bool(torch.isfinite(audio).all()):
            raise AssertionError(f"non-finite samples in the {name} render")
        if not np.array_equal(mixdown_s16(audio, configs.MIX_VOLUME).cpu().numpy(), pcm):
            raise AssertionError(f"two renders of {name} differ")
        audio_np = audio.cpu().numpy()
        check_golden(cgold[f"{name}_windows"], cgold[f"{name}_offsets"],
                     cgold[f"{name}_chunk_rms"], audio_np, name)
        mod, attr, ref = plain_paths[name]
        with mock.patch.object(mod, attr, ref):
            plain = render_performance(perf, total, CHUNK, device="cuda").cpu().numpy()
        check_plain(audio_np, plain, name)
        del perf, audio, plain

    # 7. nothing of JAX
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zang_tpu"))
    if bad:
        raise AssertionError(f"modules of jax or zang_tpu were imported: {bad}")

    by_path = {path: c["svf_table"] for path, c in launches.items() if c["svf_table"]}
    svf_row = {
        "name": "svf_table", "route": "cuda", "source": "zang_tpu_torch/csrc/svf_table.cu",
        "replaces": "zang_tpu/ops/pallas_svf.py:355",
        "launches": sum(by_path.values()), "max_abs_err": max(svf_err.values()),
        **svf_t["song"],
        "by_path": {path: {"launches": n, "max_abs_err": svf_err[path], **svf_t[path]}
                    for path, n in by_path.items()},
    }
    lookup_row = {
        "name": "table_lookup", "route": "cuda",
        "source": "zang_tpu_torch/csrc/table_lookup.cu",
        "replaces": "zang_tpu/ops/pallas_lookup.py:64",
        "launches": sum(c["table_lookup"] for c in launches.values()),
        "max_abs_err": lk_err, "ms": lk_ms, "plain_ms": lk_plain_ms,
        "bound_ms": lk_bound_ms, "bound_by": lk_bound_by,
        "library_ms": (lib_a + lib_b) / 2, "device_ms": lk_dev_ms,
    }
    print(card)
    print(json.dumps({"kernels": [svf_row, lookup_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
