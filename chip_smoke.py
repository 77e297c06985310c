#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zang_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repo root, on a machine with CUDA, nvcc and torch. Phases, each
of which raises on failure:

  1. the card: nvidia-smi name and power limit, torch's device name
  2. build the CUDA kernel from zang_tpu_torch/csrc/ (nvcc, into
     zang_tpu_torch/build/)
  3. the table-cut SVF kernel against its plain torch version
     (svf_filter_table_ref) on the card: the song's shape, a ragged shape
     and a state chain across two calls; rms < -120 dBFS, end states within
     1e-5; kernel and plain timed with CUDA events at the song's shape
  4. the full 385 s Bach Toccata through render_song_s16(device="cuda"),
     with the kernel's launch count reset just before and read just after
  5. fidelity without JAX: the render against the JAX package's golden
     windows (zang_tpu_torch/data/song_golden_jax.npz, < -90 dBFS RMS), and
     against the card's own plain-path render
  6. no jax module was imported

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernel with its launches, error and times. Exits non-zero, printing no
result, without CUDA or outside a checkout of the repo.
"""

import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_DB = -120.0  # kernel vs plain (tests/test_ops_effects.py:270, :297)
TOL_STATE = 1e-5  # end states (tests/test_ops_effects.py:271-272)
PARITY_DB = -90.0  # the parity budget (FIDELITY.md)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rms_db(a, b) -> float:
    import numpy as np

    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30))


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
                cutv=to(cutv, torch.float32), af=to(af, torch.int32))


def check_kernel(filters, c, t0, label):
    """Kernel vs plain on one case; returns max |out diff|."""
    import torch

    args = (c["l0"], c["b0"], c["x"], "low_pass", c["tb"], c["cutv"], 0.7, t0, c["af"])
    lk, bk, ok = filters.svf_filter_table(*args)
    lr, br, orf = filters.svf_filter_table_ref(*args)
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
    lr, br, full = filters.svf_filter_table_ref(
        c["l0"], c["b0"], c["x"], "low_pass", c["tb"], c["cutv"], 0.7, t0, c["af"])
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
    from zang_tpu_torch.core.mixdown import mixdown_s16
    from zang_tpu_torch.graph.fidelity import deviation_dbfs
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host import song
    from zang_tpu_torch.ops import filters, svf_cuda

    # 1. the card
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    dev = torch.device("cuda")

    # 2. build
    t = time.perf_counter()
    nvcc_s = svf_cuda.build()
    print(f"build: svf_table.cu in {time.perf_counter() - t:.2f}s "
          f"(nvcc {nvcc_s:.2f}s)")

    # 3. kernel vs plain on the card
    rng = np.random.default_rng(20261016)
    print(f"kernel vs svf_filter_table_ref (rms < {TOL_DB} dBFS, "
          f"end state |diff| < {TOL_STATE}):")
    t0_song = 7 * 65536
    song_case = svf_case(rng, 14, 65536, 128, 2, t0_song, dev)
    err = check_kernel(filters, song_case, t0_song, "song shape")
    err = max(err, check_kernel(filters, svf_case(rng, 3, 2048, 4, 3, 4096, dev),
                                4096, "ragged shape"))
    check_chain(filters, rng, dev)
    c = song_case
    args = (c["l0"], c["b0"], c["x"], "low_pass", c["tb"], c["cutv"], 0.7, t0_song,
            c["af"])
    plain_a = time_ms(lambda: filters.svf_filter_table_ref(*args), 10)
    ms_a = time_ms(lambda: filters.svf_filter_table(*args), 100)
    ms_b = time_ms(lambda: filters.svf_filter_table(*args), 100)
    plain_b = time_ms(lambda: filters.svf_filter_table_ref(*args), 10)
    ms, plain_ms = (ms_a + ms_b) / 2, (plain_a + plain_b) / 2
    print(f"  time at the song shape [{card}]: kernel {ms_a:.4f} / {ms_b:.4f} ms, "
          f"plain {plain_a:.4f} / {plain_b:.4f} ms")

    # 4. the full song, main path
    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    svf_cuda.svf_table_launches = 0
    t = time.perf_counter()
    pcm = song.render_song_s16(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = svf_cuda.svf_table_launches
    n_chunks = -(-total // 65536)
    print(f"song: render_song_s16(device='cuda'): {pcm.shape[0]} frames in "
          f"{wall:.3f}s end to end (RTF {song.NUM_SECONDS / wall:.1f}), "
          f"{launches} svf_table launches [{card}]")
    if pcm.shape != (total,) or pcm.dtype != np.int16:
        raise AssertionError(f"pcm {pcm.shape} {pcm.dtype}, expected ({total},) int16")
    if launches != n_chunks:
        raise AssertionError(f"{launches} svf_table launches, expected {n_chunks}")
    if np.count_nonzero(pcm) < total // 2:
        raise AssertionError("the render is mostly silent")

    # the same path in its two timed steps, for plan and device seconds
    t = time.perf_counter()
    perf = song.build_performance(total)
    plan_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    mix = render_performance(perf, total, 65536, device="cuda")[0]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    print(f"song: plan {plan_s:.3f}s, device render {render_s:.3f}s, "
          f"RTF {song.NUM_SECONDS / render_s:.1f} (render only) [{card}]")
    if not bool(torch.isfinite(mix).all()):
        raise AssertionError("non-finite samples in the render")
    if not np.array_equal(mixdown_s16(mix, song.MIX_VOLUME).cpu().numpy(), pcm):
        raise AssertionError("two renders of the song differ")

    # 5. fidelity
    gold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "song_golden_jax.npz"))
    if int(gold["total"]) != total:
        raise AssertionError("golden file is for another song length")
    mix_np = mix.cpu().numpy()
    ours = np.stack([mix_np[o:o + int(gold["window"])] for o in gold["offsets"]])
    gold_db, gold_peak = deviation_dbfs(ours, gold["windows"])
    print(f"fidelity vs JAX golden ({len(gold['offsets'])} windows of "
          f"{int(gold['window'])}): rms {gold_db:.1f} dBFS, peak {gold_peak:.1f} dBFS "
          f"(budget {PARITY_DB})")
    if not gold_db < PARITY_DB:
        raise AssertionError(f"render is {gold_db:.1f} dBFS from the JAX golden")
    # |rms(a) - rms(b)| <= rms(a - b): every chunk within the budget keeps
    # its RMS within 10^(-90/20) of the golden's
    chunk = int(gold["chunk_size"])
    ours_rms = np.array([np.sqrt(np.mean(mix_np[i:i + chunk].astype(np.float64) ** 2))
                         for i in range(0, total, chunk)])
    d_rms = float(np.abs(ours_rms - gold["chunk_rms"]).max())
    print(f"per-chunk RMS vs JAX golden ({len(ours_rms)} chunks): max |diff| "
          f"{d_rms:.3e} (bound {10 ** (PARITY_DB / 20):.3e})")
    if not d_rms < 10 ** (PARITY_DB / 20):
        raise AssertionError("a chunk's RMS is off the JAX golden's")
    with mock.patch.object(filters, "svf_filter_table", filters.svf_filter_table_ref):
        plain_mix = render_performance(perf, total, 65536, device="cuda")[0]
    plain_db, plain_peak = deviation_dbfs(mix_np, plain_mix.cpu().numpy())
    print(f"fidelity vs the card's plain-path render: rms {plain_db:.1f} dBFS, "
          f"peak {plain_peak:.1f} dBFS")
    if not plain_db < PARITY_DB:
        raise AssertionError(f"render is {plain_db:.1f} dBFS from the plain path")

    # 6. no JAX
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "svf_table", "route": "cuda",
        "source": "zang_tpu_torch/csrc/svf_table.cu",
        "replaces": "zang_tpu/ops/pallas_svf.py:355",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
