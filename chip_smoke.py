#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zang_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repo root, on a machine with CUDA, nvcc, g++ and torch. Phases,
each of which raises on failure:

  1. the card: nvidia-smi name and power limit, torch's device name
  2. build, all at once: the six CUDA kernels from zang_tpu_torch/csrc/
     (nvcc, one process per source), the C++ host compiler and the
     reference oracle's inner loops (g++, csrc/zang_host.cpp and
     csrc/zang_oracle.cpp), into zang_tpu_torch/build/
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
  4. K4, the table-lookup kernel: its fused entry (sampler_play, the
     sampler's whole chunk from its tiled program in one launch: the slot
     walk, the position, the wrap, both taps and the inverted lerp) against
     sampler_play_ref (eval_tiled_chunk, then eval_sampler) on the card,
     bit for bit (signs of zero included) on every chunk of real programs
     (plan_sampler, chunkify_tiled): the sampler config's (one slot a tile,
     ratio 0.5) at its chunk and at the example's, looped and one shot at
     ratios 1.0 (the copy path), 0.7 and 1.3, reverse at -1.0 and -0.7,
     dense retriggers (four slots) and a 300,000-sample table; timed a call
     at the config's and the example's shapes beside (a) the chain it
     replaced (eval_tiled_chunk, then eval_sampler through sampler_taps),
     (b) the yardstick, that chain with torch.take taps from the same
     inputs, which it must beat as it must (a), and (c) the library call,
     one torch.take on the chunk's indices wrapped and made int64
     beforehand, with its device time, bound and the host's microseconds a
     call. Then its two-tap entry (sampler_taps, both of the sampler's
     taps of a chunk in one launch, which the flat chunk format keeps)
     against sampler_taps_ref on the card, bit for bit: the sampler
     config's shape (looped, indices wrapping both ways), the sampler
     example's, a one-shot case with out-of-range indices and the
     262,144-entry table; and the generic entry (table_lookup) against
     table_lookup_ref: the sampler's shape, the example's (idx 32 x 512),
     the largest table, one-shot edges. Both timed as K1, beside the plain
     version; the two-tap entry, looped and one shot, also beside the
     library call (one torch.take on indices stacked, wrapped or clipped
     and made int64 beforehand; one shot times a sel made beforehand),
     beside the fewest PyTorch calls that compute its function from its
     own inputs (the yardstick, which it must not lose to) and beside the
     two-launch path it replaced, with the host's microseconds a call
  5. K2, the dense-cut SVF kernel, against svf_filter_ref on the card:
     the play example's shape (V=1, n=16384, scalar cutoff, mask), the
     stereo example's (V=2, [2, 1] cutoff, no mask, resonance 0.4), the
     detuned example's two calls (V=2, scalar cutoff: 4 Hz, resonance 0, no
     mask; 7040 Hz with a mask), a ragged n with a [V, 1] cutoff, a state
     chain across two calls, V=1024, n=65536 with a dense cutoff and
     mask, the flat song's chunk (V=14, n=65000: the organ part's dense
     cutoff over the song's first chunk and its activity mask) and
     render_midi's filteredsaw part (its voices, n=16384, its scalar
     cutoff, a mask), and the zangscript shapes: the script example's
     delay sub-chunk (V=1 x 8192, the feedback Filter's scalar cutoff 0.2,
     res 0, the active window's mask as a slice of the chunk's) and the
     midi_script parts' sub-chunks (V=8 and 2 x 8192); rms < -120 dBFS,
     end states within 1e-5; at the play, stereo, detuned, ragged, flat
     song, filteredsaw and script shapes also bit for bit against
     svf_dense_emulated, its seams composed in torch; timed as K1 (per call
     at the play, V=1024, flat song, filteredsaw and script shapes, device
     time at each example's), with its latency floor at play's shape
     (svf_chain_floor_us, printed only)
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
     main path's V=16384 x 65536 written over its input, and the cases
     where the kernel's batch paths part (tests/test_torch_cuda_kernels.py
     ONEPASS_EDGES: active_from and slot boundaries inside a 32-sample
     batch and on its first sample, unsorted slots, a time tile that ends
     inside a batch, 1-4 slots, V not a multiple of 32, n = 4 (mod 128)),
     each written over its input, and two chained calls into outputs of
     their own; the router sends
     five slots a tile to K1 instead (V=4096, held to
     svf_filter_table_ref; one K1 launch, no K3), and at V=16384 x 65536
     with donate_x the peak device memory of that call is read;
     against K1 and K1's plain version at V=4096 (rms < -120 dBFS, end
     states within 1e-5); timed beside K1 called by name at 1024, 4096 and
     16384 voices x 65536 frames, each K3 time beside its chain floor
     (onepass_chain_floor_ms, printed only) and its bytes-bound share
  6c. W, the tile-window cut (csrc/tile_windows.cu), against its plain
     version tile_windows_ref on the same tables on the card, bit for bit
     and dtype for dtype, on every chunk of the song's four programs and of
     poly_echo's two at 4096 voices x 8 s (plan_windows at chunk 65536),
     the chunk's first frame by value and read from the card; each
     program's cut of its middle chunk timed a call beside the plain
     version, with its device time beside its bound (the bytes it writes)
  7. the main paths, each with every kernel's launch count set to 0 just
     before it and read just after (W's apart from the other five: one
     launch a SegProgram and chunk on every path that takes window plans,
     checked on the song and the configs below):
       song       the full 385 s Bach Toccata, render_song_s16(device="cuda"):
                  282 K1 launches, 1,128 W
       sampler    10 s, render_config_s16("sampler", device="cuda"):
                  7 K4 launches (the fused entry, one a chunk; its own
                  count 7 too), 7 W, the render bit for bit with the same
                  render through the chain the fused entry replaced
                  (eval_chunk, then eval_sampler with the two-tap entry)
       poly_echo  1024 voices x 30 s stereo, render_config_s16("poly_echo",
                  device="cuda"): 21 K1 launches, 42 W
       poly_echo at 4096 and at 16384 voices x 8 s (the JAX package's
                  capacity sizes), render_config_s16("poly_echo", 8.0,
                  voices=N, device="cuda"): 6 K3 launches, no K1 and 12 W each,
                  peak device memory under 64 GiB
     then each again in its two timed steps (plan, device render); then
       song_flat  the full song at a 65,000-frame chunk (the flat chunk
                  format), song.build_performance and
                  render_performance(..., device="cuda"): 285 K2 launches
                  and no K1 (the organ's dense-cut branch)
       midi_toccata  zang_tpu_torch/data/toccata.mid (the song as a
                  Standard MIDI File) through render_midi with the nice
                  instrument at its defaults (48 kHz, 2 s of tail, chunk
                  16384, each part's peak polyphony): 3 K1 launches a chunk
       midi_mixed the same file with pmosc, filteredsaw and weirdsquare
                  cycled over the parts, 60 s: 176 K2 launches
       the zang-midi CLI, python -m zang_tpu_torch.host.midi toccata.mid
                  OUT.wav --device cuda, a process of its own: its WAV is
                  midi_toccata's render mixed down (mixdown_s16_np)
       midi_script the whole file through render_midi with the zangscript
                  instrument zang_tpu_torch/data/demo_synth.txt:DemoSynth
                  (the script example's synth) on every part: K2 in each
                  delay's feedback loop, two sub-chunks a chunk and part,
                  6,780 launches; then the same through the CLI
                  (--instrument demo_synth.txt:DemoSynth), its WAV the
                  render mixed down
  7b. the song streamed: stream_performance at chunk 65536 on the card,
     282 K1 launches, the blocks concatenated equal to phase 7's render bit
     for bit
  8. fidelity without JAX: each render against the JAX package's golden
     windows (zang_tpu_torch/data/*_golden_jax.npz, < -90 dBFS RMS, every
     channel; song_flat also against the tiled song's windows, printed
     only) and against the card's own plain-path render (4096 voices,
     song_flat, midi_toccata, midi_mixed and midi_script: the first
     chunk; 16384 voices: K3 is held to its loop at that shape in 6b
     instead); midi_script's golden holds windows only, and the script
     file's SHA-256
  9. the twenty examples (zang_tpu_torch/host/examples.py EXAMPLES), each
     through its ex_* entry on the card at its default seconds, with the
     launch counts checked (ceil(frames / chunk) a chunk-launched kernel:
     play 18 K2, fmsynth 12 K5, polyphony 15 K1, polyphony2 18 K1,
     sampler 17 K4 (the fused entry; bit for bit with its render through
     the chain it replaced), song 15 K1, stereo 18 K2, detuned 30 K2 (two a chunk),
     script 34 K2 (two sub-chunks a chunk), script_runtime 36 K2 (two
     halves of 9 chunks), every other count 0), against the JAX
     golden windows and against the card's plain-path render (every
     router patched to its plain version by name; fmsynth at 2 s there,
     since the plain FM loop is a Python loop over samples, and bit for
     bit: K5 is the plain loop's bits). detuned is
     held in two parts, as the JAX package holds its own oracle twin (its
     warble multiplier feeds a phase counter): the multiplier against the
     JAX trajectory a chunk at a time from the JAX filter state (relative
     deviation < 1e-5), and the cascade on that trajectory against the
     golden windows; the free-running render's distance is printed
  9b. the live tier, on the card:
     K5 with a waveform a voice (an int32 [V], stride 1: mixed inside
     every warp, one a warp) and by pointer (stride 0) at the fmsynth
     example's V=8 x 16384 and a fleet's 128 x 4096, bit for bit with
     fm_feedback_ref, timed stride 0 beside stride 1; K2 at the live shapes
     (V=4 x 1024, 256 x 4096, 1024 x 4096, dense cutoff and mask) against
     svf_filter_ref (< -120 dBFS) and bit for bit against
     svf_dense_emulated; then, each with the launch counts set to 0 just
     before and read just after:
       live_session  a LiveSession of zang-serve's nice (polyphony 4,
                  block 1024) fed the Toccata's first 10 s
                  (host/song.live_events) through a NoteTracker: one K2 a
                  block (469), against the port's offline render of the
                  same events (< -110 dBFS) and the JAX golden windows
                  (zang_tpu_torch/data/live_golden_jax.npz, < -90 dBFS);
                  block times (median, p99) against the 21.3 ms budget
                  (launches a block and the busy share:
                  tools/profile_torch.py live_session); snapshot and
                  restore into a fresh session continue bit for bit
       live_fmsynth  an FMSynth session with device- and plan-kind
                  parameter changes between blocks: one K5 a block (160);
                  its first blocks bit for bit with the card's plain path
       live_fleet_4, _64, _256  LiveFleets of that many lanes (bench.py
                  bench_fleet's shape: nice, polyphony 4, block 4096, lane
                  l transposed by l % 12): one K2 a block at every L; block
                  times against the 85.3 ms budget and sessions a card
                  (bench.py:300's formula: lanes x budget / best block,
                  and by the median); the 4-lane fleet against its JAX
                  golden (< -90 dBFS) and against 4 sessions (<= 1e-6)
       live_server  a MultiInstrumentServer on localhost, four LiveClients
                  playing at once and a fifth replaying toccata.mid
                  (replay_live, the fleet grows to 8 lanes): one K2 a
                  block served; each client's PCM non-silent, of its
                  blocks' length and within 1 LSB of a session fed the
                  events its lane drained, at the blocks it drained them,
                  mixed down
  11. the serving tiers, on the card, each step with the launch counts set
     to 0 just before it and read just after (the wrappers count under a
     lock, so worker threads count exactly):
       batch      BatchRenderer(devices=["cuda:0"]) with its default
                  worker: four 385 s Toccatas (one build, traces == 1,
                  4 x 282 K1), again with four workers, and eight; the 10 s sampler
                  (7 K4), poly_echo at 1024 voices x 30 s (21 K1) and at
                  4096 voices x 8 s (6 K3, no K1); every WAV is phase 7's
                  render mixed down, bit for bit; fleet and per-job RTF,
                  peak device memory
       checkpoint render_resumable of the song at 141 chunks a segment,
                  interrupted for real after its first save (141 K1), then
                  resumed from that file in a fresh call (141 K1): phase 7's
                  render bit for bit
       http       a RenderHTTPServer(device="cuda") on 127.0.0.1: the menu;
                  /v1/render of play (K2), fmsynth (K5), polyphony (K1) and
                  sampler (K4), each with phase 9's launches and the PCM of
                  the port's own example render mixed down;
                  /v1/render/script with demo_synth.txt's DemoSynth (K2 in
                  its delay loop) and /v1/render/midi with toccata.mid,
                  nice, 60 s (K1), each the port's own render's launches and
                  bits; /v1/render/stream?config=song&seconds=385 (282 K1,
                  the body phase 7's render mixed down at volume 0.25, byte
                  for byte; the time to the first byte and to the last, peak
                  device memory); /v1/render/batch with a song, a sampler and
                  a DemoSynth job, each /v1/result/<id> the port's render
                  mixed down; a bad script's 400 with caret diagnostics;
                  /v1/stats
       visual     render_image of the streamed song's first 10 s, written
                  as a PNG and parsed back (CRCs, size)
  12. several devices (zang_tpu_torch/parallel/mesh.py), each launch of
     ranks one process a device (spawned; a file:// rendezvous), every
     rank's launch counts set to 0 just before its render and read just
     after, its kernel by its own voice count:
       (a)        NCCL at one rank on cuda:0: the whole song and poly_echo at
                  16384 voices x 8 s, each bit for bit with phase 7's
                  render_performance (282 K1; 6 K3)
       (b)        two ranks on cuda:0 through gloo (NCCL refuses two ranks
                  on one card): the same two pieces padded to 2, each rank
                  at half the voices (282 K1 a rank; 6 K3 a rank), within
                  -120 dBFS of phase 7's renders, the song also within the
                  parity budget of the JAX golden windows, both ranks' mixes
                  the same bits; every rank launches W once a SegProgram and
                  chunk; a rank's voices, kernel, timelines, plan,
                  slice and render seconds and peak device memory
       (c)        with two cards or more, (b) through NCCL over every card
       (d)        the live fleet at 256 lanes (block 4096, the Toccata's
                  first 5 s: phase 9b's live_fleet_256 cut to 59 blocks)
                  on one card and with its lanes in a group a device of
                  [cuda:0, cuda:0] (every card when there are two), in
                  turns: one K2 a group and block, every block within 1e-6
                  of the one-group fleet's, median and p99 block times
                  beside PERF.md §5's live_fleet_256
  13. the port's kernel tests on the card: `python -m pytest --noconftest
     -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
     tests/test_torch_cuda_paths.py` in a subprocess (those files import
     neither jax nor zang_tpu; the suite's conftest does), beside the soak
     of phase 14: rc 0 and every collected case passed, more than none,
     but the NCCL rank cases that ask for more cards than the machine has
     (they skip: "needs W cards")
  14. the port's bench and soak, each in a subprocess as a user runs them:
     `python -m zang_tpu_torch.bench` at a cut size (the song 60 s,
     poly_echo 4096 voices x 8 s, the sampler 10 s, serve 2 jobs x 30 s in
     one pass, the fleet at 64 lanes, no idle wait): its six JSON lines in
     bench.py's order with the headline last, finite values, the fidelity
     under the parity budget, and each metric's launches (from its `#`
     lines) those of its chunks and renders; then `python -m
     zang_tpu_torch.tools.soak --seconds 20 --clients 2 --json` (run beside
     phase 13), every invariant of its report holding
  15. the reference oracle on the card's host (zang_tpu_torch/oracle: numpy
     and C++ on the CPU, held bit for bit to the JAX package's oracle by
     tests/test_torch_oracle*.py), against which the card's renders are
     held over every frame, within the parity budget (< -90 dBFS RMS, every
     channel); the oracle's seconds are the host CPU's:
       (a)        phase 7's 385 s song (282 K1) against
                  render_song_oracle(385), printed beside its reading on the
                  JAX golden windows
       (b)        phase 9's twenty example renders (their launches checked
                  there) against their backend="oracle" twins; detuned's
                  on the JAX trajectory stored in examples_golden_jax.npz
                  (the cascade render of phase 9) against the twin fed the
                  same trajectory
       (c)        phase 7's 10 s sampler config (7 K4) against
                  render_sampler_chain(10)
       (c1)       phase 7's song_flat (the 385 s song at a 65,000-frame
                  chunk, 285 K2) against render_song_oracle(385), (a)'s
                  reference: the oracle has no chunks
       (c2)       phase 7's poly_echo at 1024 voices (21 K1) and at 4096
                  voices (6 K3 in place, NiceInstrument by groups of 2048)
                  against their oracle twin (host/configs.py
                  render_poly_echo_oracle: a NiceInstrument a voice and
                  StereoEchoes) over a cut of their first frames
                  (POLY_ORACLE_CUTS, sized from the twin's rate on the
                  card's host: about a minute of host CPU for both)
       (d)        F2: a zangscript whose delay body calls Gate (a painter)
                  and low-passes its feedback, rendered at chunks 8,192 and
                  16,384 on the card (K2 once a sub-chunk of 2,048: 24
                  launches each) against render_script_oracle
       (e)        `python -m zang_tpu_torch.host.render_wav song OUT.wav
                  --engine oracle --seconds 60`, a process of its own: its
                  WAV byte for byte render_song_oracle(60) mixed down
       (f)        the oracle's SHA-256 fingerprint of each example at
                  tools/oracle_fingerprints.py's windows against
                  tests/oracle_fingerprints.json (read as data): "k of 20
                  match" and the mismatches, printed only (detuned's
                  trajectory is the port's own; a numpy whose sin or exp
                  rounds otherwise would move the others)
  10. no module of jax or of zang_tpu was imported (checked last)

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels (W among them) with their launches, errors, times and bounds; before the
card's line, {"live": ...} holds phase 9b's block times and fidelity,
{"serve": ...} phase 11's numbers, {"multi_gpu": ...} phase 12's,
{"bench": ...} phases 13 and 14's and {"oracle": ...} phase 15's
readings and the oracle's host seconds. Exits non-zero, printing no result,
without CUDA or outside a checkout of the repo.
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
# the SegPrograms of a render (W launches once each a chunk), by config
SEGPROGRAMS = {"song": 4, "poly_echo": 2, "sampler": 1}
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
# phase 15 (d): F2, a painter (Gate) inside a delay body (the sub-chunks of
# the delay are 2,048 frames at both chunks: 4,000 >= 2,048), its feedback
# low-passed so K2 runs in the loop; tests/test_torch_oracle.py renders it
# on the CPU
F2_SCRIPT = """
F2 = defmodule freq: cob, note_on: boolean, begin
    out delay 4000 begin
        out Gate(note_on) * PulseOsc(freq, color=0.5) * 0.3 + feedback * 0.5
        feedback Filter(input=Gate(note_on) * PulseOsc(freq, color=0.5) * 0.3,
                        type=.low_pass, cutoff=0.2, res=0)
    end
end
"""
F2_NOTES = [(0.1, 0.3, 220.0), (0.5, 0.2, 330.0), (0.8, 0.25, 440.0)]
F2_TOTAL, F2_SUB = 3 * 16384, 2048
ORACLE_CLI_SECONDS = 60.0
# phase 15 (c2): poly_echo's renders held to the oracle twin over their first
# frames: (voices, the piece's seconds, frames). The twin runs a Python voice
# stack a voice and block on the host: 4.7-7.0 M voice-samples a second on
# the H100 machine's host (NVIDIA H100 80GB HBM3, 700.00 W), so these two
# cost about a minute of it together
POLY_ORACLE_CUTS = {"poly_echo": (1024, 30.0, 176_400),        # 4 s of 30 s
                    "poly_echo_4096": (4096, 8.0, 55_125)}     # 1.25 s of 8 s
# tools/oracle_fingerprints.py's render windows (seconds)
FINGERPRINT_WINDOW = {
    "play": 2.0, "envelope": 2.0, "vibrato": 2.0, "curve": 2.0,
    "laser": 2.0, "subsong": 3.0, "two": 2.5, "arpeggiator": 2.0,
    "polyphony": 2.0, "stereo": 2.0, "detuned": 2.0, "portamento": 2.0,
    "mouse": 2.0, "fmsynth": 2.0, "sampler": 2.0, "polyphony2": 2.0,
    "delay": 2.5, "script": 2.0, "script_runtime": 2.0, "song": 4.0,
}


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
    wrapper's host cost too when the kernel is short). The profiler may drop
    records of a run (it was seen to keep 168 of 200, and in a long process
    19 of 100 or none): the mean is over the launches it saw, at least half
    of them, in one of three tries; past that, the CUDA events' time of
    back-to-back calls stands in, and a note says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()  # a launch at a time: fewer records dropped
        rows = [e for e in prof.key_averages() if kernel_name in e.key]
        n = sum(e.count for e in rows)
        if 0.5 * reps <= n <= reps:
            us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
            return us / 1e3 / n
        if n > reps:
            raise AssertionError(f"the profiler saw {n} launches of {kernel_name}, "
                                 f"expected {reps}")
    ms = time_ms(fn, reps)
    print(f"    (the profiler saw {n} of {reps} launches of {kernel_name} three times: "
          f"CUDA events of back-to-back calls instead, {ms:.4f} ms)")
    return ms


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


def onepass_chain_floor_ms(n, mhz):
    """K3's latency floor in ms at `mhz`, an estimate: n steps of the SVF's
    dependent chain (SVF_STEP_CHAIN operations from the state in to the
    state out, at CYCLES_PER_DEPENDENT_OP each), as a batch in which every
    lane is active steps them (no select). zang_tpu_torch/tools/chain_floor.py
    onepass counts the same from the built code."""
    return n * SVF_STEP_CHAIN * CYCLES_PER_DEPENDENT_OP / (mhz * 1e3)


def run_onepass(card, dev, rng, filters, svf_cuda, mhz):
    """K3, the one-pass table-cut SVF kernel: against its plain loop
    (svf_onepass_table_ref; bit for bit), against K1 and K1's plain version
    (TOL_DB, TOL_STATE), and timed beside K1 called by name at 1024, 4096
    and 16384 voices x 65536 frames, each time beside K3's chain floor and
    its bytes bound; the cases at the edges of K3's batches
    (tests/test_torch_cuda_kernels.py ONEPASS_EDGES) and two chained calls
    into outputs of their own, bit for bit; and the router's K1 branch for
    five slots a tile. Returns (errs, times, k1_times) by shape,
    errs["router S=5"] that K1 launch's; the V=16384 entry carries the
    plain loop's one timed run."""
    import torch

    threads = torch.get_num_threads()  # the test module sets one thread
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_cuda_kernels import ONEPASS_EDGES, onepass_edge_args, onepass_edge_case
    torch.set_num_threads(threads)

    k3, k1 = svf_cuda.svf_onepass_cuda, svf_cuda.svf_table_cuda
    ref = filters.svf_onepass_table_ref
    print("K3 svf_onepass vs svf_onepass_table_ref (bit for bit), and vs K1 and "
          f"svf_filter_table_ref (rms < {TOL_DB} dBFS, end state |diff| < {TOL_STATE}):")
    errs = {}
    # through the router: V >= ONEPASS_V_MIN, active_from inside the chunk
    before, = launched("svf_onepass")
    a = svf_case(rng, 4096, 2048, 128, 3, 512, dev)
    errs["v4096 n2048"] = check_svf(svf_label("router", a), filters.svf_filter_table, ref,
                                    a, exact=True)
    if launched("svf_onepass") != (before + 1,):
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
    before = launched("svf_onepass", "svf_table")
    errs["router S=5"] = check_svf(svf_label("router, 5 slots", a),
                                   lambda *args: filters.svf_filter_table(*args,
                                                                          donate_x=True),
                                   filters.svf_filter_table_ref, a)
    if launched("svf_onepass", "svf_table") != (before[0], before[1] + 1) or \
            not torch.equal(a[2], x_in):
        raise AssertionError("svf_filter_table did not take K1 alone at V=4096, S=5, or "
                             "wrote over x")
    a = svf_case(rng, 16384, CHUNK, 128, 5, 3 * CHUNK, dev)
    torch.cuda.synchronize()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    before = launched("svf_onepass", "svf_table")
    got = filters.svf_filter_table(*a, donate_x=True)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launched("svf_onepass", "svf_table") != (before[0], before[1] + 1):
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
    # where the kernel's batch paths part (active_from and slot boundaries
    # inside and on its 32-sample batches, unsorted slots, a time tile that
    # ends inside a batch, 1-4 slots, ragged V and n), written over x
    for name in ONEPASS_EDGES:
        a = onepass_edge_args(onepass_edge_case(name), dev)
        x_in = a[2].clone()
        errs[name] = check_svf(svf_label(f"edges, {name}, out=x", a), in_place,
                               lambda *args: ref(args[0], args[1], x_in, *args[3:]), a,
                               exact=True)
    # two calls into outputs of their own, the second from the first's end
    a = onepass_edge_args(onepass_edge_case("V 97"), dev, "all_pass")
    V, n2 = a[2].shape
    n, nt = n2 // 2, a[4].shape[1] // 2
    check_svf_chain(f"chained 2 x {n} at V={V}, all_pass, out apart", k3, ref, a,
                    lambda k, l, b: (l, b, a[2][:, k * n:(k + 1) * n].contiguous(), "all_pass",
                                     a[4][:, k * nt:(k + 1) * nt].contiguous(),
                                     a[5][:, k * nt:(k + 1) * nt].contiguous(), a[6],
                                     a[7] + k * n, a[8]), exact=True)
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
        floor_ms = onepass_chain_floor_ms(CHUNK, mhz)
        dev_ms = times[key]["device_ms"]
        print(f"  K3 V={V}: device {dev_ms:.4f} ms, {floor_ms / dev_ms:.1%} of the way to its "
              f"chain floor of {floor_ms:.4f} ms ({SVF_STEP_CHAIN} dependent operations a step "
              f"at {CYCLES_PER_DEPENDENT_OP} cycles, {mhz:.0f} MHz) and "
              f"{times[key]['bound_ms'] / dev_ms:.1%} of its bytes bound "
              f"({times[key]['bound_ms'] * 1e3:.1f} us)")
        k1_times[key] = timing(card, f"K1 by name, V={V}", lambda a=a: k1(*a), None,
                               "svf_table_kernel", n_bytes, n_ops, reps, 1)
        if V == 16384:
            # what moving the same bytes takes without the filter: one copy
            # of x into a buffer of its own (printed only)
            out = torch.empty_like(a[2])
            copy_ms = time_ms(lambda: out.copy_(a[2]), reps)
            del out
            print(f"  a plain copy of x (out.copy_(x), {8 * V * CHUNK} B moved): "
                  f"{copy_ms:.4f} ms; K3's device time is {dev_ms / copy_ms:.3f}x it [{card}]")
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


# phase 4: the fused entry's cases, real programs (plan_sampler, chunkify_tiled)
# at the config's chunk: name -> (loop, speed, seconds between notes, the
# piece's seconds). The drum loop is at 22,050 Hz, so the ratio is speed / 2.
PLAY_CASES = {
    "looped, ratio 1.0 (the copy path)": (True, 2.0, 0.8, 3.0),
    "looped, ratio 0.7": (True, 1.4, 0.8, 3.0),
    "looped, ratio 1.3": (True, 2.6, 0.8, 3.0),
    "looped, reverse at 1.0": (True, -2.0, 0.8, 3.0),
    "looped, reverse at 0.7": (True, -1.4, 0.8, 3.0),
    "one shot, ratio 1.0": (False, 2.0, 0.8, 3.0),
    "one shot, ratio 1.3": (False, 2.6, 0.8, 3.0),
    "one shot, reverse (silent)": (False, -2.0, 0.8, 3.0),
    "dense retriggers (4 slots)": (True, 1.8, 0.005, 1.5),
}
PLAY_LONG_TABLE = 300_000  # samples, beyond the TPU kernel's 128 x 2048
PLAY_OPS_PER_SAMPLE = 10  # the slot's f32 position, floor, lerp and casts


def play_programs(configs, case, chunk):
    """(chunked tiled program [nc, V, nt, S], table f32 numpy, num_samples,
    ratio, loop) of a PLAY_CASES entry, of "config" (the sampler config's
    own 10 s program: one note at frame 0, one slot a tile) or of "long
    table, looped" / "long table, one shot" (PLAY_LONG_TABLE random samples
    at ratio 1.3 over 8 s, past the table's end)."""
    import numpy as np

    from zang_tpu_torch.core.notes import SongEvent
    from zang_tpu_torch.core.timeline import compile_timelines
    from zang_tpu_torch.ops import sampler as sampler_ops
    from zang_tpu_torch.ops.segprog import chunkify_tiled

    sr = configs.SAMPLE_RATE
    if case == "config":
        perf, total = configs.build_sampler_performance()
        inst, sp = perf.parts[0][0], perf.programs[0]["sampler"]
        data, N, ratio, loop = inst.table.data_f32, inst.table.num_samples, inst.ratio, True
    elif case.startswith("long table"):
        loop, N, total = case.endswith("looped"), PLAY_LONG_TABLE, int(8.0 * sr)
        data = np.random.default_rng(9).standard_normal(N).astype(np.float32)
        tls = compile_timelines([SongEvent({"note_on": True}, t=0.0, note_id=1)], 1, sr,
                                total)
        sp = sampler_ops.plan_sampler(tls[0], sampler_ops.SampleTable(data, N, 2 * N,
                                                                      1.3 * sr), sr, loop)
        ratio = float(np.float32(np.float32(1.3 * sr) / np.float32(sr)))
    else:
        loop, speed, gap, seconds = PLAY_CASES[case]
        total = int(seconds * sr)
        song = [SongEvent({"note_on": True}, t=i * gap, note_id=i + 1)
                for i in range(int((seconds - 0.2) / gap) + 1)]
        tls = compile_timelines(song, 1, sr, total)
        inst = configs.SamplerInstrument(loop=loop, speed=speed, distort=False,
                                         fake_sample_rate=None)
        sp = inst.plan(tls, sr)["sampler"]
        data, N, ratio = inst.table.data_f32, inst.table.num_samples, inst.ratio
    return chunkify_tiled(sp, chunk, -(-total // chunk), total), data, N, ratio, loop


def check_play(sampler_ops, lookup, programs, chunk, device, label):
    """The fused entry against sampler_play_ref on every chunk, bit for bit
    (signs of zero included), one launch a chunk on both of K4's counters.
    Returns max |diff| (0.0)."""
    import torch

    xs, data, N, ratio, loop = programs
    table = torch.from_numpy(data).to(device)
    n_chunks, V, nt, S = xs["tb"].shape
    err, modes = 0.0, set()
    for c in range(n_chunks):
        prog = {k: torch.from_numpy(v[c]).to(device) for k, v in xs.items()}
        t_idx = torch.arange(c * chunk, (c + 1) * chunk, dtype=torch.int32, device=device)
        before = launched("table_lookup", "sampler_play")
        got = sampler_ops.sampler_play(prog, t_idx, table, N, ratio, loop)
        after = launched("table_lookup", "sampler_play")
        want = sampler_ops.sampler_play_ref(prog, t_idx, table, N, ratio, loop)
        torch.cuda.synchronize()
        if after != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"{label}: the fused entry's counts went {before} -> {after}")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{label}: sampler_play disagrees with sampler_play_ref "
                                 f"in chunk {c}")
        err = max(err, float((got - want).abs().max()))
        modes |= set(prog["mode"].unique().tolist())
    print(f"  {label}: {n_chunks} chunks of V={V} x {chunk} ({nt} tiles, S={S}), N={N}, "
          f"ratio {ratio:g}, {'looped' if loop else 'one shot'}, modes {sorted(modes)}: "
          f"bit-exact")
    return err


def play_timing(card, sampler_ops, lookup, label, chunk, device):
    """The fused entry a call at one of the sampler config's chunks (its
    second), beside its plain version, (a) the chain it replaced, (b) that
    chain with torch.take taps from the same inputs and (c) one torch.take
    on the chunk's two taps' indices, wrapped and made int64 beforehand;
    its device time, bound and the host's microseconds a call. Raises
    unless it is faster a call than (a) and (b)."""
    import torch

    from zang_tpu_torch.host import configs
    from zang_tpu_torch.ops.segprog import eval_tiled_chunk

    xs, data, N, ratio, loop = play_programs(configs, "config", chunk)
    prog = {k: torch.from_numpy(v[1]).to(device) for k, v in xs.items()}
    t_idx = torch.arange(chunk, 2 * chunk, dtype=torch.int32, device=device)
    table = torch.from_numpy(data).to(device)
    args = (prog, t_idx, table, N, ratio, loop)

    def take_taps(ia, ib, tbl, n, lp):
        p = torch.stack((ia, ib))
        if lp:
            return torch.take(tbl, torch.remainder(p, n).long())
        return torch.take(tbl, p.clamp(0, n - 1).long()) * ((p >= 0) & (p < n))

    seen = []

    def seeing_taps(ia, ib, *rest):
        seen.append(torch.stack((ia, ib)))
        return lookup.sampler_taps_ref(ia, ib, *rest)

    fused = lambda: sampler_ops.sampler_play(*args)
    chain = lambda: sampler_ops.eval_sampler(eval_tiled_chunk(prog, t_idx), t_idx, table, N,
                                             ratio, loop)
    yardstick = lambda: sampler_ops.eval_sampler(eval_tiled_chunk(prog, t_idx), t_idx, table,
                                                 N, ratio, loop, taps=take_taps)
    sampler_ops.eval_sampler(eval_tiled_chunk(prog, t_idx), t_idx, table, N, ratio, loop,
                             taps=seeing_taps)
    prepared = torch.remainder(seen[0], N).long()
    library = ("torch.take on the chunk's wrapped int64 indices",
               lambda: torch.take(table, prepared))
    want = fused().view(torch.int32)
    if not (torch.equal(chain().view(torch.int32), want)
            and torch.equal(yardstick().view(torch.int32), want)):
        raise AssertionError(f"{label}: the chains differ from the fused entry")
    V, nt, S = prog["tb"].shape
    n_bytes = 16 * V * nt * S + 4 * chunk + 4 * V * chunk + 4 * N
    t = timing(card, f"{label} (sampler_play, V={V} x {chunk}, S={S})", fused,
               lambda: sampler_ops.sampler_play_ref(*args), "sampler_play_kernel", n_bytes,
               PLAY_OPS_PER_SAMPLE * V * chunk, 500, 50, library=library)
    a = [time_ms(chain, 100), time_ms(yardstick, 100), time_ms(yardstick, 100),
         time_ms(chain, 100)]
    h = [host_us(f, r) for f, r in ((fused, 500), (chain, 100), (yardstick, 100),
                                     (library[1], 500))]
    t.update(chain_ms=(a[0] + a[3]) / 2, yardstick_ms=(a[1] + a[2]) / 2, host_us=h[0],
             chain_host_us=h[1], yardstick_host_us=h[2], library_host_us=h[3])
    print(f"  {label} [{card}]: (a) the chain it replaced {a[0]:.4f} / {a[3]:.4f} ms, "
          f"(b) that chain with torch.take taps {a[1]:.4f} / {a[2]:.4f} ms, the fused "
          f"call {t['ms']:.4f} ms; host a call: fused {h[0]:.1f} us, (a) {h[1]:.1f} us, "
          f"(b) {h[2]:.1f} us, (c) {h[3]:.1f} us")
    if not (t["ms"] < t["chain_ms"] and t["ms"] < t["yardstick_ms"]):
        raise AssertionError(f"{label}: the fused call is not faster than the chain it "
                             f"replaced and the yardstick")
    return t


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
# W, the tile-window cut (phase 6c)


def run_windows(card, dev):
    """W against tile_windows_ref on the same tables on the card, bit for
    bit, on every chunk of the song's programs and of poly_echo's at 4096
    voices x 8 s, the first frame by value and from the card; each
    program's middle chunk timed. Returns (errs, times) by shape."""
    import torch
    from zang_tpu_torch.graph import render as trender
    from zang_tpu_torch.host import configs, song
    from zang_tpu_torch.ops import tile_windows as tw
    from zang_tpu_torch.ops.segprog import SegProgram, plan_windows

    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    pieces = {"song": (song.build_performance(total), total),
              "poly_echo_4096": configs.build_poly_echo_performance(num_voices=4096,
                                                                    seconds=8.0)}
    errs, times = {}, {}
    for piece, (perf, total) in pieces.items():
        n_chunks = -(-total // CHUNK)
        sps = trender._leaves(perf.programs, SegProgram)
        tables = trender._leaves(trender._upload_tables(sps, dev), tw.SegTable)
        for p, (sp, table) in enumerate(zip(sps, tables)):
            label = f"{piece}.{p}"
            plan = plan_windows(sp, CHUNK, n_chunks, total)
            for i in range(n_chunks):
                c0 = torch.tensor([i * CHUNK], dtype=torch.int32, device=dev)
                want = tw.tile_windows_ref(table, plan, i * CHUNK)
                for got in (tw.tile_windows_cuda(table, plan, i * CHUNK),
                            tw.tile_windows_cuda(table, plan, c0)):
                    if got.keys() != want.keys() or not all(
                            got[k].dtype == w.dtype and torch.equal(got[k], w)
                            for k, w in want.items()):
                        raise AssertionError(f"W {label} chunk {i}: not the plain cut")
            errs[label] = 0.0
            V, K = sp.starts.shape
            written = V * plan.nt * plan.S * (4 + sum(v.element_size()
                                                      for v in table.values.values()))
            print(f"  W {label}: V={V}, K={K}, S={plan.S}, {n_chunks} chunks, bit for bit "
                  f"with tile_windows_ref on the card, c0 by value and from the card")
            c0 = torch.tensor([(n_chunks // 2) * CHUNK], dtype=torch.int32, device=dev)
            times[label] = timing(card, f"W {label}",
                                  lambda: tw.tile_windows_cuda(table, plan, c0),
                                  lambda: tw.tile_windows_ref(table, plan, c0),
                                  "windows_kernel", written, 0, 200, 50)
    return errs, times


# ---------------------------------------------------------------------------
# main paths


def counts(svf_cuda, lookup, fm):
    """The five render kernels' launch counts in this process (the port's
    "launch.<kernel>" counters, read through zang_tpu_torch/parallel/mesh.py,
    which a rank reads too), W's left out: launched("tile_windows") reads
    it where a path checks it."""
    from zang_tpu_torch.parallel.mesh import launch_counts

    c = launch_counts()
    c.pop("tile_windows")
    return c


def launched(*kernels) -> tuple:
    """counts()' values of `kernels`, in order."""
    from zang_tpu_torch.parallel.mesh import launch_counts

    c = launch_counts()
    return tuple(c[k] for k in kernels)


def reset_counts(svf_cuda, lookup, fm):
    from zang_tpu_torch.parallel.mesh import reset_launch_counts

    reset_launch_counts()


def expect_counts(**n):
    """The launch counts a path should show: those given, 0 for the rest;
    sampler_play (the fused entry's share of table_lookup's) defaults to
    table_lookup's, as on every tiled path."""
    n.setdefault("sampler_play", n.get("table_lookup", 0))
    return {k: n.get(k, 0) for k in ("svf_table", "svf_dense", "svf_onepass",
                                     "table_lookup", "sampler_play", "fm_feedback")}


def check_golden(gold_windows, offsets, chunk_rms_gold, audio, label, chunk=CHUNK):
    """audio: f32 numpy [C, total]. Windows within the parity budget and
    each chunk's RMS within 10^(budget/20) of the golden's (|rms(a) - rms(b)|
    <= rms(a - b)); chunk_rms_gold None: the windows only."""
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
    if chunk_rms_gold is None:
        return max(db for db, _ in dbs)
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


def check_plain(audio, plain_audio, label, against="the card's plain-path render"):
    """audio, plain_audio: f32 numpy [C, n]; every channel within the parity
    budget of the other. Returns the worst channel's dBFS."""
    from zang_tpu_torch.graph.fidelity import deviation_dbfs

    if audio.shape != plain_audio.shape:
        raise AssertionError(f"{label}: {audio.shape} against {against}'s "
                             f"{plain_audio.shape}")
    worst = -float("inf")
    for ch in range(audio.shape[0]):
        db, peak = deviation_dbfs(audio[ch], plain_audio[ch])
        print(f"  {label} vs {against}, channel {ch}: "
              f"rms {db:.1f} dBFS, peak {peak:.1f} dBFS")
        if not db < PARITY_DB:
            raise AssertionError(f"{label}: {db:.1f} dBFS from {against}")
        worst = max(worst, float(db))
    return worst


# the kernel each example launches once a render chunk (detuned's twice: its
# two filters); the other examples launch none
EXAMPLE_KERNEL = {"play": ("svf_dense", 1), "fmsynth": ("fm_feedback", 1),
                  "polyphony": ("svf_table", 1), "polyphony2": ("svf_table", 1),
                  "sampler": ("table_lookup", 1), "song": ("svf_table", 1),
                  "stereo": ("svf_dense", 1), "detuned": ("svf_dense", 2),
                  # the delay of 11,025 halves a 16,384-frame chunk: the
                  # feedback Filter runs once a sub-chunk
                  "script": ("svf_dense", 2), "script_runtime": ("svf_dense", 2)}
# examples rendered in parts: script_runtime renders its two halves (before
# and after the reload) each from frame 0
EXAMPLE_PARTS = {"script_runtime": 2}
TOL_WARBLE = 1e-5  # detuned's warble multiplier vs the JAX trajectory, relative
FM_PLAIN_SECONDS = 2.0  # fmsynth's plain-path render (a Python loop over samples)


def plain_routers(filters, fm, lookup):
    """Every kernel router patched to its plain version by name."""
    from contextlib import ExitStack

    from zang_tpu_torch.ops import sampler as sampler_ops

    stack = ExitStack()
    for mod, attr, ref in ((filters, "svf_filter", filters.svf_filter_ref),
                           (filters, "svf_filter_table", filters.svf_filter_table_ref),
                           (fm, "fm_feedback", fm.fm_feedback_ref),
                           (lookup, "table_lookup", lookup.table_lookup_ref),
                           (lookup, "sampler_taps", lookup.sampler_taps_ref),
                           (sampler_ops, "sampler_play", sampler_ops.sampler_play_ref)):
        stack.enter_context(mock.patch.object(mod, attr, ref))
    return stack


def old_sampler_chain():
    """SamplerInstrument.render's chunk as it ran before the fused entry:
    eval_chunk, then eval_sampler with its taps through the two-tap entry
    (sampler_taps, a K4 launch that sampler_play's count does not see)."""
    from zang_tpu_torch.ops import sampler as sampler_ops
    from zang_tpu_torch.ops.segprog import eval_chunk

    def chain(prog, t_idx, table, num_samples, ratio, loop):
        return sampler_ops.eval_sampler(eval_chunk(prog, t_idx), t_idx, table, num_samples,
                                        ratio, loop)

    return mock.patch.object(sampler_ops, "sampler_play", chain)


def check_old_chain(audio_np, render, label, chunks):
    """audio_np: a render through the fused entry (f32 numpy); render() the
    same render, returning a tensor: through the old chain it must give the
    same bits, with `chunks` two-tap launches and no fused one."""
    import numpy as np

    from zang_tpu_torch.parallel.mesh import reset_launch_counts

    reset_launch_counts()
    with old_sampler_chain():
        chain = render().cpu().numpy()
    got = counts(None, None, None)
    same = chain.shape == audio_np.shape and np.array_equal(chain.view(np.int32),
                                                           audio_np.view(np.int32))
    print(f"  {label} through the chain the fused entry replaced (eval_chunk, then "
          f"eval_sampler with sampler_taps; launches {got}): "
          f"{'bit for bit' if same else 'DIFFERS'}")
    if got != expect_counts(table_lookup=chunks, sampler_play=0):
        raise AssertionError(f"{label}: the old chain's launches {got}")
    if not same:
        raise AssertionError(f"{label}: the fused entry's render is not the old chain's")


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
    return cascade


def run_examples(examples, filters, fm, lookup, svf_cuda, card, launches):
    """Each registered example through its ex_* entry on the card at its
    default seconds: launch counts, shape, finiteness, the JAX golden
    windows and the card's plain-path render. Adds each run's launch counts
    to `launches` under "ex_<name>". Returns {name: the render, f32 numpy
    [C, total]} (detuned's on the JAX trajectory) for phase 15."""
    import inspect

    import numpy as np
    import torch

    gold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "examples_golden_jax.npz"))
    params = json.loads(str(gold["params"]))["examples"]
    if sorted(params) != sorted(examples.EXAMPLES):
        raise AssertionError(f"the examples' golden holds {sorted(params)}, the registry "
                             f"{sorted(examples.EXAMPLES)}")
    renders = {}
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
        parts = EXAMPLE_PARTS.get(name, 1)
        want = expect_counts(**({kname: taps * parts * -(-(total // parts) // chunk)}
                                if kname else {}))
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
            renders[name] = check_detuned(examples, filters, fm, lookup, svf_cuda, gold, p,
                                          audio_np, launches)
            continue
        renders[name] = audio_np
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
        if name == "sampler":
            check_old_chain(audio_np, lambda: fn(device="cuda")[0], name,
                            -(-total // chunk))
    return renders


# ---------------------------------------------------------------------------
# the flat chunk format, MIDI input and streaming

SONG_FLAT_CHUNK = 65000  # not a whole number of 512-frame tiles: the flat format
MIDI_FILE = os.path.join(ROOT, "zang_tpu_torch", "data", "toccata.mid")
MIDI_MIXED = ("pmosc", "filteredsaw", "weirdsquare")  # cycled over the parts
MIDI_MIXED_SECONDS = 60.0
SCRIPT_FILE = os.path.join(ROOT, "zang_tpu_torch", "data", "demo_synth.txt")
SCRIPT_DELAY = 11025  # DemoSynth's delay: a 16,384-frame chunk halves to 8,192


def flat_song_case(rng, perf, total, device):
    """K2's inputs at the flat song's shape: the merged organ part's dense
    cutoff and activity over the song's first 65,000-frame chunk, as
    NiceInstrument's flat branch evaluates them (V=14), and a random x."""
    import numpy as np
    import torch

    from zang_tpu_torch.ops.segprog import eval_chunk

    xs, _ = perf.chunk_xs(total, SONG_FLAT_CHUNK)
    phase = xs[1]["phase"]
    t_idx = torch.arange(SONG_FLAT_CHUNK, dtype=torch.int32, device=device)
    cut = eval_chunk({k: torch.as_tensor(phase[k][0], device=device)
                      for k in ("starts", "cut")}, t_idx)["cut"]
    af = torch.as_tensor(perf.programs[1]["active_from"], device=device)
    act = t_idx[None, :] >= af[:, None]
    V = cut.shape[0]
    to = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return (to(rng.standard_normal(V) * 0.1), to(rng.standard_normal(V) * 0.1),
            to(rng.standard_normal((V, SONG_FLAT_CHUNK)) * 0.3), "low_pass", cut, 0.7, act)


def script_case(rng, V, chunk, device):
    """K2's inputs at a zangscript delay sub-chunk: the chunk halved to
    chunk / 2 <= the delay of 11,025 frames, the feedback Filter's scalar
    cutoff 0.2 and res 0 (both plan-time constants), the active window's
    mask the second sub-chunk's slice of the chunk's (a strided view, as
    the backend passes it), x contiguous."""
    import numpy as np
    import torch

    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    s = chunk // 2
    act = to(rng.uniform(size=(V, chunk)) > 0.1, torch.bool)[:, s:]
    return (to(rng.standard_normal(V) * 0.1, torch.float32),
            to(rng.standard_normal(V) * 0.1, torch.float32),
            to(rng.standard_normal((V, s)) * 0.3, torch.float32), "low_pass",
            float(np.float32(0.2)), 0.0, act)


def midi_mixed_maker(midi):
    stock = midi.stock_instruments()
    return lambda pi, label: stock[MIDI_MIXED[pi % len(MIDI_MIXED)]]()


def first_chunk_plain(perf, total, chunk, filters, fm, lookup, svf_cuda):
    """The first chunk of perf's render through every plain version on the
    card (a stream's first block), f32 numpy [C, chunk]."""
    from zang_tpu_torch.graph.render import stream_performance

    reset_counts(svf_cuda, lookup, fm)
    with plain_routers(filters, fm, lookup):
        block = next(stream_performance(perf, total, chunk, device="cuda"))
    if any(counts(svf_cuda, lookup, fm).values()):
        raise AssertionError("the plain path launched a kernel")
    return block


def run_flat_midi_stream(card, filters, fm, lookup, svf_cuda, launches, song_mix):
    """Phases 7 (song_flat, midi_toccata, midi_mixed, the zang-midi CLI),
    7b (the song streamed) and 8 (their golden windows and first chunks on
    the plain path). song_mix: phase 7's render of the song, f32 numpy
    [1, total]. Adds each run's launch counts to `launches`. Returns the
    song_flat render, f32 numpy [1, total] (74 MB), for phase 15 (c1)."""
    import hashlib
    import tempfile

    import numpy as np
    import torch

    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.core.wav import read_wav
    from zang_tpu_torch.graph.fidelity import deviation_dbfs
    from zang_tpu_torch.graph.render import render_performance, stream_performance
    from zang_tpu_torch.host import midi, song

    data_dir = os.path.join(ROOT, "zang_tpu_torch", "data")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # song_flat: the whole song at a 65,000-frame chunk, every chunk flat
    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    reset_counts(svf_cuda, lookup, fm)
    perf, plan_s = timed(lambda: song.build_performance(total))
    mix, render_s = timed(lambda: render_performance(perf, total, SONG_FLAT_CHUNK,
                                                     device="cuda"))
    launches["song_flat"] = counts(svf_cuda, lookup, fm)
    print(f"song_flat: render_performance(song, {total}, chunk_size={SONG_FLAT_CHUNK}, "
          f"device='cuda'): plan {plan_s:.3f}s, device render {render_s:.3f}s (RTF "
          f"{song.NUM_SECONDS / render_s:.1f} render only), launches "
          f"{launches['song_flat']} [{card}]")
    want = expect_counts(svf_dense=-(-total // SONG_FLAT_CHUNK))
    if launches["song_flat"] != want:
        raise AssertionError(f"song_flat: launches {launches['song_flat']}, expected {want}")
    if tuple(mix.shape) != (1, total) or not bool(torch.isfinite(mix).all()):
        raise AssertionError(f"song_flat: {tuple(mix.shape)}, or non-finite samples")
    flat_np = mix.cpu().numpy()
    del mix
    gold = np.load(os.path.join(data_dir, "song_flat_golden_jax.npz"))
    p = json.loads(str(gold["params"]))
    if (p["chunk_size"], p["total"]) != (SONG_FLAT_CHUNK, total):
        raise AssertionError(f"the song_flat golden was made for {p}")
    check_golden(gold["windows"], gold["offsets"], gold["chunk_rms"], flat_np[0],
                 "song_flat", chunk=SONG_FLAT_CHUNK)
    tiled = np.load(os.path.join(data_dir, "song_golden_jax.npz"))
    w = tiled["windows"].shape[-1]
    db, peak = deviation_dbfs(np.stack([flat_np[0, o:o + w] for o in tiled["offsets"]]),
                              tiled["windows"])
    print(f"  song_flat vs the tiled song's JAX golden ({len(tiled['offsets'])} windows "
          f"of {w}), printed only: rms {db:.1f} dBFS, peak {peak:.1f} dBFS")
    check_plain(flat_np[:, :SONG_FLAT_CHUNK],
                first_chunk_plain(perf, total, SONG_FLAT_CHUNK, filters, fm, lookup,
                                  svf_cuda), "song_flat (first chunk)")
    del perf

    # the Toccata as an SMF through render_midi: all nice, then three instruments
    with open(MIDI_FILE, "rb") as f:
        data = f.read()
    mgold = np.load(os.path.join(data_dir, "midi_golden_jax.npz"))
    mp = json.loads(str(mgold["params"]))
    if mp["sha256"] != hashlib.sha256(data).hexdigest():
        raise AssertionError("the midi golden was made from another file")
    nice = midi.stock_instruments()["nice"]
    runs = [("midi_toccata", "toccata", lambda pi, label: nice(), None, "svf_table"),
            ("midi_mixed", "mixed", midi_mixed_maker(midi), MIDI_MIXED_SECONDS, "svf_dense")]
    rendered = {}
    for name, entry, maker, seconds, kname in runs:
        g = mp[entry]
        names = ["nice"] if entry == "toccata" else list(MIDI_MIXED)
        if (g["instruments"], g["seconds"], g["tail"], g["sample_rate"], g["chunk_size"]) \
                != (names, seconds, 2.0, 48000.0, 16384):
            raise AssertionError(f"the midi golden's {entry} was made for {g}")
        reset_counts(svf_cuda, lookup, fm)
        audio, wall = timed(lambda: midi.render_midi(data, maker, seconds=seconds,
                                                     device="cuda"))
        launches[name] = counts(svf_cuda, lookup, fm)
        perf, plan_s = timed(lambda: midi.midi_performance(data, maker, seconds=seconds))
        perf, total = perf
        chunk = midi.midi_chunk(total)
        again, render_s = timed(lambda: render_performance(perf, total, chunk, device="cuda"))
        polys = [len(tls) for _, tls in perf.parts]
        print(f"{name}: render_midi(toccata.mid, {'nice' if entry == 'toccata' else MIDI_MIXED}"
              f"{'' if seconds is None else f', seconds={seconds:g}'}, device='cuda'): "
              f"{total} frames ({total / 48000.0:.2f} s) at chunk {chunk}, polyphony "
              f"{polys}; {wall:.3f}s end to end; plan {plan_s:.3f}s, device render "
              f"{render_s:.3f}s (RTF {total / 48000.0 / render_s:.1f} render only), "
              f"launches {launches[name]} [{card}]")
        n_chunks = -(-total // chunk)
        per_chunk = len(perf.parts) if kname == "svf_table" else 1
        want = expect_counts(**{kname: per_chunk * n_chunks})
        if launches[name] != want:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {want}")
        if g["total"] != total or tuple(audio.shape) != (1, total):
            raise AssertionError(f"{name}: {tuple(audio.shape)}, the golden's total "
                                 f"{g['total']}")
        if not bool(torch.isfinite(audio).all()) or not torch.equal(audio, again):
            raise AssertionError(f"{name}: non-finite samples, or two renders differ")
        audio_np = audio.cpu().numpy()
        del audio, again
        check_golden(mgold[f"{entry}_windows"], mgold[f"{entry}_offsets"],
                     mgold[f"{entry}_chunk_rms"], audio_np, name, chunk=chunk)
        check_plain(audio_np[:, :chunk],
                    first_chunk_plain(perf, total, chunk, filters, fm, lookup, svf_cuda),
                    f"{name} (first chunk)")
        rendered[name] = audio_np
        del perf

    # the zang-midi CLI of the port, as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "toccata.wav")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "zang_tpu_torch.host.midi", MIDI_FILE, out,
             "--device", "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"python -m zang_tpu_torch.host.midi failed:\n{proc.stderr}")
        w = read_wav(out)
        pcm = np.frombuffer(w.data, np.int16)
    want = mixdown_s16_np(rendered["midi_toccata"], 0.25).reshape(-1)
    same = (w.num_channels, w.sample_rate) == (1, 48000) and np.array_equal(pcm, want)
    print(f"zang-midi CLI: python -m zang_tpu_torch.host.midi toccata.mid OUT.wav --device "
          f"cuda: {proc.stdout.strip()} in {wall:.1f}s (a process of its own); the WAV "
          f"{'equals' if same else 'DIFFERS from'} mixdown_s16_np of midi_toccata's render")
    if not same:
        raise AssertionError("the CLI's WAV is not midi_toccata's render mixed down")

    # midi_script: the whole file with the zangscript DemoSynth on every part
    sgold = np.load(os.path.join(data_dir, "midi_script_golden_jax.npz"))
    sp = json.loads(str(sgold["params"]))
    with open(SCRIPT_FILE, "rb") as f:
        script_sha = hashlib.sha256(f.read()).hexdigest()
    if (sp["midi_sha256"], sp["script_sha256"]) != (mp["sha256"], script_sha):
        raise AssertionError("the midi_script golden was made from another file or script")
    if (sp["module"], sp["seconds"], sp["tail"], sp["sample_rate"], sp["chunk_size"]) \
            != ("DemoSynth", None, 2.0, 48000.0, 16384):
        raise AssertionError(f"the midi_script golden was made for {sp}")
    script_inst = midi._instrument_maker(f"{SCRIPT_FILE}:DemoSynth")
    maker = lambda pi, label: script_inst()
    reset_counts(svf_cuda, lookup, fm)
    audio, wall = timed(lambda: midi.render_midi(data, maker, device="cuda"))
    launches["midi_script"] = counts(svf_cuda, lookup, fm)
    (perf, total), plan_s = timed(lambda: midi.midi_performance(data, maker))
    chunk = midi.midi_chunk(total)
    again, render_s = timed(lambda: render_performance(perf, total, chunk, device="cuda"))
    sub = chunk
    while sub > SCRIPT_DELAY:
        sub //= 2
    polys = [len(tls) for _, tls in perf.parts]
    print(f"midi_script: render_midi(toccata.mid, demo_synth.txt:DemoSynth, "
          f"device='cuda'): {total} frames ({total / 48000.0:.2f} s) at chunk {chunk}, "
          f"sub-chunks of {sub} in the delay loop, polyphony {polys}; {wall:.3f}s end to "
          f"end; plan {plan_s:.3f}s, device render {render_s:.3f}s (RTF "
          f"{total / 48000.0 / render_s:.1f} render only), launches "
          f"{launches['midi_script']} [{card}]")
    want = expect_counts(svf_dense=(chunk // sub) * len(perf.parts) * -(-total // chunk))
    if launches["midi_script"] != want:
        raise AssertionError(f"midi_script: launches {launches['midi_script']}, "
                             f"expected {want}")
    if sp["total"] != total or tuple(audio.shape) != (1, total):
        raise AssertionError(f"midi_script: {tuple(audio.shape)}, the golden's total "
                             f"{sp['total']}")
    if not bool(torch.isfinite(audio).all()) or not torch.equal(audio, again):
        raise AssertionError("midi_script: non-finite samples, or two renders differ")
    script_np = audio.cpu().numpy()
    del audio, again
    check_golden(sgold["windows"], sgold["offsets"], None, script_np, "midi_script",
                 chunk=chunk)
    check_plain(script_np[:, :chunk],
                first_chunk_plain(perf, total, chunk, filters, fm, lookup, svf_cuda),
                "midi_script (first chunk)")
    del perf
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "toccata_script.wav")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "zang_tpu_torch.host.midi", MIDI_FILE, out,
             "--instrument", f"{SCRIPT_FILE}:DemoSynth", "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"the zang-midi CLI with a script instrument failed:\n"
                                 f"{proc.stderr}")
        w = read_wav(out)
        pcm = np.frombuffer(w.data, np.int16)
    same = (w.num_channels, w.sample_rate) == (1, 48000) and np.array_equal(
        pcm, mixdown_s16_np(script_np, 0.25).reshape(-1))
    print(f"zang-midi CLI: python -m zang_tpu_torch.host.midi toccata.mid OUT.wav "
          f"--instrument demo_synth.txt:DemoSynth --device cuda: {proc.stdout.strip()} in "
          f"{wall:.1f}s (a process of its own); the WAV "
          f"{'equals' if same else 'DIFFERS from'} mixdown_s16_np of midi_script's render")
    if not same:
        raise AssertionError("the CLI's WAV is not midi_script's render mixed down")
    del script_np

    # 7b. the song streamed at the tiled chunk: the render's bits, block by block
    total = song_mix.shape[1]
    perf = song.build_performance(total)
    reset_counts(svf_cuda, lookup, fm)
    blocks, wall = timed(lambda: list(stream_performance(perf, total, CHUNK,
                                                         device="cuda")))
    launches["song_stream"] = counts(svf_cuda, lookup, fm)
    streamed = np.concatenate(blocks, axis=1)
    same = streamed.shape == song_mix.shape and np.array_equal(streamed, song_mix)
    print(f"song streamed: stream_performance(song, {total}, {CHUNK}, device='cuda'): "
          f"{len(blocks)} blocks in {wall:.3f}s, launches {launches['song_stream']}; "
          f"concatenated {'equal' if same else 'NOT equal'} to the render bit for bit "
          f"[{card}]")
    if launches["song_stream"] != expect_counts(svf_table=-(-total // CHUNK)):
        raise AssertionError(f"song stream: launches {launches['song_stream']}")
    if not same:
        raise AssertionError("the streamed song is not the song's render")
    return flat_np


# ---------------------------------------------------------------------------
# the serving tiers: the batch fleet, checkpointed renders, HTTP, the visualizer
# (phase 11)

SONG_SEGMENT = 141  # render_resumable's segment: the song's 282 chunks in two halves
HTTP_EXAMPLES = ("play", "fmsynth", "polyphony", "sampler")  # K2, K5, K1, K4
HTTP_MIDI_SECONDS = 60.0
VISUAL_SECONDS = 10.0


def _http(srv, method, path, body=None, timeout=600.0):
    """(status, bytes, seconds to the first body byte, seconds to the last)."""
    import http.client

    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=timeout)
    try:
        t = time.perf_counter()
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        first = r.read(1)
        t_first = time.perf_counter() - t
        data = first + r.read()
        return r.status, data, t_first, time.perf_counter() - t
    finally:
        conn.close()


def _wav_pcm(data: bytes):
    """(sample rate, channels, int16 [frames * channels]) of a WAV response."""
    import struct

    import numpy as np

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AssertionError(f"not a WAV: {data[:64]!r}")
    n = struct.unpack_from("<I", data, 40)[0]
    return (struct.unpack_from("<I", data, 24)[0], struct.unpack_from("<H", data, 22)[0],
            np.frombuffer(data[44:44 + n], dtype=np.int16))


def _png_size(path):
    """(width, height) of an 8-bit RGB PNG, its chunks' CRCs and its pixel
    data checked."""
    import struct
    import zlib

    with open(path, "rb") as f:
        png = f.read()
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(png):
        n, tag = struct.unpack_from(">I4s", png, pos)
        body = png[pos + 8:pos + 8 + n]
        if struct.unpack_from(">I", png, pos + 8 + n)[0] != zlib.crc32(tag + body):
            raise AssertionError(f"PNG chunk {tag!r}: bad CRC")
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack_from(">IIBB", chunks[b"IHDR"])
    if (depth, color) != (8, 2) or len(zlib.decompress(chunks[b"IDAT"])) != h * (1 + 3 * w):
        raise AssertionError("PNG pixel data does not fit its header")
    return w, h


def run_serve(card, filters, fm, lookup, svf_cuda, launches, song_mix, config_pcm):
    """Phase 11: the batch fleet, a checkpointed render interrupted and
    resumed, the HTTP render tier and the visualizer, each step with the
    launch counts set to 0 just before it and read just after (the
    wrappers count under a lock, so the batch's worker threads count
    exactly). song_mix: phase 7's song render, f32 numpy [1, total];
    config_pcm: phase 7's s16 renders of the configs. Returns the
    {"serve": ...} numbers."""
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.core.wav import read_wav, read_wav_f32
    from zang_tpu_torch.graph import checkpoint
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host import configs, examples, midi, song, visual
    from zang_tpu_torch.serve import http
    from zang_tpu_torch.serve.batch import BatchRenderer, RenderJob

    out = {}
    total = song_mix.shape[1]
    seconds = total / song.SAMPLE_RATE
    song_pcm = mixdown_s16_np(song_mix[0], song.MIX_VOLUME)
    tmp = tempfile.mkdtemp(prefix="zang_serve_")
    try:
        # -- the batch fleet: four Toccatas through one build, then the configs
        def batch(label, jobs, expect, pcm_of, **kw):
            br = BatchRenderer(out_dir=os.path.join(tmp, label), devices=["cuda:0"], **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(svf_cuda, lookup, fm)
            t = time.perf_counter()
            results = br.run(jobs)
            wall = time.perf_counter() - t
            launches[label] = counts(svf_cuda, lookup, fm)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            audio_s = sum(r.seconds for r in results)
            print(f"{label}: BatchRenderer(devices=['cuda:0'], workers_per_device="
                  f"{br.workers_per_device}) {len(jobs)} jobs, {audio_s:.1f} s of audio in "
                  f"{wall:.3f}s (fleet RTF {audio_s / wall:.1f}; per job "
                  f"{', '.join(f'{r.rtf:.1f}' for r in results)}), traces "
                  f"{br.cache.traces}, peak device memory {peak:.2f} GiB, launches "
                  f"{launches[label]} [{card}]")
            bad = [(r.name, r.error) for r in results if r.status != "ok"]
            if bad:
                raise AssertionError(f"{label}: jobs failed: {bad}")
            if launches[label] != expect:
                raise AssertionError(f"{label}: launches {launches[label]}, expected {expect}")
            for r in results:
                w = read_wav(r.wav_path)
                got = np.frombuffer(w.data, np.int16)
                want = pcm_of(r.name)
                if not np.array_equal(got, np.ascontiguousarray(want.T).reshape(-1)):
                    d = np.abs(got.astype(np.int32)
                               - np.ascontiguousarray(want.T).reshape(-1).astype(np.int32))
                    raise AssertionError(f"{label}/{r.name}: the WAV is not the render's "
                                         f"mixdown (max {d.max()} LSB apart)")
            return dict(jobs=len(jobs), audio_s=audio_s, wall_s=wall,
                        fleet_rtf=audio_s / wall, job_rtf=[r.rtf for r in results],
                        job_wall_s=[r.wall_s for r in results],
                        workers=br.workers_per_device, traces=br.cache.traces,
                        peak_gib=peak), br

        def songs(n):
            return [RenderJob(f"toccata_{i}", lambda: (song.build_performance(total), total),
                              volume=song.MIX_VOLUME) for i in range(n)]

        n_song = -(-total // CHUNK)
        out["batch_songs"], br = batch("batch_songs", songs(4),
                                       expect_counts(svf_table=4 * n_song),
                                       lambda name: song_pcm)
        if br.cache.traces != 1 or out["batch_songs"]["traces"] != 1:
            raise AssertionError(f"four songs of one structure built {br.cache.traces} steps")
        # the same four with four workers (the JAX package's default on an
        # 8-core host: do more workers help?), and eight with the default
        out["batch_songs_4_workers"], _ = batch(
            "batch_songs_4_workers", songs(4), expect_counts(svf_table=4 * n_song),
            lambda name: song_pcm, workers_per_device=4)
        out["batch_songs_8"], _ = batch("batch_songs_8", songs(8),
                                        expect_counts(svf_table=8 * n_song),
                                        lambda name: song_pcm)
        for label, config, secs, voices, kname in (
                ("batch_sampler", "sampler", 10.0, None, "table_lookup"),
                ("batch_poly_echo", "poly_echo", 30.0, 1024, "svf_table"),
                ("batch_poly_echo_4096", "poly_echo_4096", 8.0, 4096, "svf_onepass")):
            frames = int(secs * configs.SAMPLE_RATE)
            build = ((lambda: configs.build_sampler_performance()) if voices is None else
                     (lambda v=voices, s=secs: configs.build_poly_echo_performance(
                         num_voices=v, seconds=s)))
            out[label], _ = batch(label, [RenderJob(config, build, volume=configs.MIX_VOLUME)],
                                  expect_counts(**{kname: -(-frames // CHUNK)}),
                                  lambda name, c=config: config_pcm[c])

        # -- a checkpointed render of the song, interrupted after its first save
        class Interrupted(Exception):
            pass

        path = os.path.join(tmp, "song_ckpt.npz")
        real_save = checkpoint.save_checkpoint
        saved = []

        def save_then_stop(*a, **k):
            t = time.perf_counter()
            real_save(*a, **k)
            saved.append(time.perf_counter() - t)
            raise Interrupted

        reset_counts(svf_cuda, lookup, fm)
        t = time.perf_counter()
        with mock.patch.object(checkpoint, "save_checkpoint", save_then_stop):
            try:
                checkpoint.render_resumable(song.build_performance(total), total, path, CHUNK,
                                            segment_chunks=SONG_SEGMENT, device="cuda")
                raise AssertionError("render_resumable was not interrupted")
            except Interrupted:
                pass
        first_s = time.perf_counter() - t
        launches["checkpoint_first"] = counts(svf_cuda, lookup, fm)
        kept = os.path.join(tmp, "song_ckpt_first.npz")
        shutil.copy(path, kept)
        reset_counts(svf_cuda, lookup, fm)
        t = time.perf_counter()
        resumed = checkpoint.render_resumable(song.build_performance(total), total, kept,
                                              CHUNK, segment_chunks=SONG_SEGMENT,
                                              device="cuda")
        resume_s = time.perf_counter() - t
        launches["checkpoint_resume"] = counts(svf_cuda, lookup, fm)
        same = resumed.shape == song_mix.shape and np.array_equal(resumed, song_mix)
        print(f"checkpoint: render_resumable(song, segment_chunks={SONG_SEGMENT}, "
              f"device='cuda') interrupted after its first save ({first_s:.3f}s, the save "
              f"{saved[0]:.3f}s, {os.path.getsize(kept) / 2 ** 20:.1f} MiB, launches "
              f"{launches['checkpoint_first']}), resumed from that file in a fresh call "
              f"({resume_s:.3f}s, launches {launches['checkpoint_resume']}): "
              f"{'the song render bit for bit' if same else 'NOT the song render'} [{card}]")
        left = n_song - SONG_SEGMENT
        if launches["checkpoint_first"] != expect_counts(svf_table=SONG_SEGMENT):
            raise AssertionError(f"checkpoint: first call launches {launches['checkpoint_first']}")
        if launches["checkpoint_resume"] != expect_counts(svf_table=left):
            raise AssertionError(f"checkpoint: resume launches {launches['checkpoint_resume']}")
        if not same:
            raise AssertionError("the resumed song is not phase 7's render")
        out["checkpoint"] = dict(first_s=first_s, save_s=saved[0], resume_s=resume_s,
                                 file_mib=os.path.getsize(kept) / 2 ** 20,
                                 resumed_k1=launches["checkpoint_resume"]["svf_table"])
        del resumed

        # -- the HTTP render tier on localhost
        with http.RenderHTTPServer(device="cuda", max_notes=1024) as srv:
            status, data, _, _ = _http(srv, "GET", "/v1/examples")
            menu = json.loads(data)
            if status != 200 or "song" not in menu["examples"]:
                raise AssertionError(f"the menu: {status} {data[:200]!r}")
            http_t = {}

            def served(label, method, path, body, expect, want_pcm=None):
                reset_counts(svf_cuda, lookup, fm)
                status, data, first, last = _http(srv, method, path, body)
                torch.cuda.synchronize()
                launches[label] = counts(svf_cuda, lookup, fm)
                if status != 200:
                    raise AssertionError(f"{label}: {status} {data[:300]!r}")
                sr, ch, pcm = _wav_pcm(data)
                print(f"{label}: {method} {path}: {len(data)} bytes, first byte "
                      f"{first:.3f}s, last {last:.3f}s, launches {launches[label]} [{card}]")
                if launches[label] != expect:
                    raise AssertionError(f"{label}: launches {launches[label]}, "
                                         f"expected {expect}")
                if want_pcm is not None and not np.array_equal(pcm, want_pcm):
                    raise AssertionError(f"{label}: the PCM is not the port's render mixed "
                                         f"down")
                http_t[label] = dict(first_byte_s=first, last_byte_s=last, bytes=len(data))
                return sr, ch, pcm, data

            for name in HTTP_EXAMPLES:
                _, _, pcm, _ = served(f"http_{name}", "GET", f"/v1/render?example={name}",
                                      None, launches[f"ex_{name}"])
                audio, _ = examples.EXAMPLES[name](device="cuda")
                want = mixdown_s16_np(audio.cpu().numpy(), 0.25)
                if not np.array_equal(pcm, np.ascontiguousarray(want.T).reshape(-1)):
                    raise AssertionError(f"http_{name}: not the port's example render")
            with open(SCRIPT_FILE) as f:
                script_body = {"script": f.read(), "module": "DemoSynth"}
            # the port's own render of each request, counted: the served one
            # must launch as much and be its bits mixed down
            sperf, stotal = http._build_script_job({**script_body, "seconds": 4.0})
            schunk = min(16384, stotal)
            reset_counts(svf_cuda, lookup, fm)
            want = mixdown_s16_np(render_performance(sperf, stotal, schunk, device="cuda")
                                  .cpu().numpy(), 0.25)
            ref = counts(svf_cuda, lookup, fm)
            # the delay of 11,025 halves a 16,384-frame chunk: K2 twice a chunk
            if ref != expect_counts(svf_dense=2 * -(-stotal // schunk)):
                raise AssertionError(f"DemoSynth's render launched {ref}")
            served("http_script", "POST", "/v1/render/script", dict(script_body), ref,
                   want.reshape(-1))
            with open(MIDI_FILE, "rb") as f:
                mid = f.read()
            nice = lambda pi, label: midi.stock_instruments()["nice"]()
            mperf, mtotal = midi.midi_performance(mid, nice, seconds=HTTP_MIDI_SECONDS,
                                                  skip_channels=(9,))
            n_midi = len(mperf.parts) * -(-mtotal // midi.midi_chunk(mtotal))
            reset_counts(svf_cuda, lookup, fm)
            mwant = mixdown_s16_np(midi.render_midi(
                mid, nice, seconds=HTTP_MIDI_SECONDS, skip_channels=(9,),
                device="cuda").cpu().numpy(), 0.25)
            if counts(svf_cuda, lookup, fm) != expect_counts(svf_table=n_midi):
                raise AssertionError(f"render_midi launched {counts(svf_cuda, lookup, fm)}")
            import base64

            served("http_midi", "POST", "/v1/render/midi",
                   {"midi_base64": base64.b64encode(mid).decode(), "instrument": "nice",
                    "seconds": HTTP_MIDI_SECONDS}, expect_counts(svf_table=n_midi),
                   mwant.reshape(-1))
            torch.cuda.reset_peak_memory_stats()
            sr, ch, pcm, data = served(
                "http_stream", "GET", f"/v1/render/stream?config=song&seconds={seconds:g}",
                None, expect_counts(svf_table=n_song), song_pcm)
            http_t["http_stream"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            if (sr, ch, len(data)) != (int(song.SAMPLE_RATE), 1, 44 + 2 * total):
                raise AssertionError(f"http_stream: {sr} Hz, {ch} channels, {len(data)} bytes")
            stream_wav = os.path.join(tmp, "stream.wav")
            with open(stream_wav, "wb") as f:
                f.write(data)
            del data

            # a song, a sampler and a script job; each result fetched back
            job_script = {**script_body, "seconds": 4.0}
            reset_counts(svf_cuda, lookup, fm)
            t = time.perf_counter()
            status, data, _, _ = _http(srv, "POST", "/v1/render/batch", {"jobs": [
                {"name": "song", "config": "song", "seconds": seconds},
                {"name": "drums", "config": "sampler", "seconds": 10.0},
                {"name": "synth", **job_script}]})
            batch_s = time.perf_counter() - t
            launches["http_batch"] = counts(svf_cuda, lookup, fm)
            if status != 200:
                raise AssertionError(f"http_batch: {status} {data[:300]!r}")
            results = {r["name"]: r for r in json.loads(data)["results"]}
            reset_counts(svf_cuda, lookup, fm)
            sperf, stotal = http._build_script_job(dict(job_script))
            swant = mixdown_s16_np(render_performance(sperf, stotal, CHUNK, device="cuda")
                                   .cpu().numpy(), 0.25).reshape(-1)
            script_k2 = counts(svf_cuda, lookup, fm)["svf_dense"]
            expect = expect_counts(svf_table=n_song, svf_dense=script_k2,
                                   table_lookup=-(-int(10.0 * configs.SAMPLE_RATE) // CHUNK))
            print(f"http_batch: POST /v1/render/batch (song {seconds:g} s, sampler 10 s, "
                  f"DemoSynth 4 s) in {batch_s:.3f}s: "
                  f"{[(n, r['status'], r['rtf']) for n, r in results.items()]}, launches "
                  f"{launches['http_batch']} [{card}]")
            if launches["http_batch"] != expect:
                raise AssertionError(f"http_batch: launches {launches['http_batch']}, "
                                     f"expected {expect}")
            for name, want in (("song", song_pcm), ("drums", config_pcm["sampler"].reshape(-1)),
                               ("synth", swant)):
                r = results[name]
                if r["status"] != "ok":
                    raise AssertionError(f"http_batch/{name}: {r}")
                status, data, _, _ = _http(srv, "GET", r["url"])
                if status != 200 or not np.array_equal(_wav_pcm(data)[2], want):
                    raise AssertionError(f"http_batch/{name}: {r['url']} is not the port's "
                                         f"render mixed down")
            http_t["http_batch"] = dict(wall_s=batch_s,
                                        job_rtf={n: r["rtf"] for n, r in results.items()})
            status, data, _, _ = _http(srv, "POST", "/v1/render/script",
                                       {"script": "Broken = defmodule begin out NoSuchThing() "
                                                  "end"})
            err = json.loads(data).get("error", "")
            print(f"http: a bad script answers {status}: {err.splitlines()[:3]}")
            if status != 400 or "^" not in err:
                raise AssertionError(f"a bad script: {status} {err!r}")
            status, data, _, _ = _http(srv, "GET", "/v1/stats")
            stats = json.loads(data)
            print(f"http: /v1/stats {stats}")
            if status != 200 or stats["failures"] or stats["renders"] < 7:
                raise AssertionError(f"http stats: {stats}")
            out["http"] = dict(http_t, stats=stats)

        # -- the visualizer on the streamed song's first seconds
        audio, sr = read_wav_f32(stream_wav)
        x = audio[0, :int(VISUAL_SECONDS * sr)]
        t = time.perf_counter()
        img = visual.render_image(x, sr, title="toccata")
        png = os.path.join(tmp, "toccata.png")
        visual.write_png(png, img)
        vis_s = time.perf_counter() - t
        w, h = _png_size(png)
        print(f"visual: render_image of the streamed song's first {VISUAL_SECONDS:g} s -> "
              f"{png} {w}x{h} in {vis_s:.3f}s (host)")
        if (w, h) != (img.shape[1], img.shape[0]) or not img.any():
            raise AssertionError("the visualizer's PNG")
        out["visual"] = dict(width=w, height=h, seconds=vis_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# live sessions, fleets and the TCP server (phase 9b)

LIVE_SECONDS = 10.0  # the Toccata's first 10 s (host/song.live_events)
LIVE_FLEET_LANES = (4, 64, 256)  # bench.py bench_fleet's 64, zang-serve's max 256
LIVE_TOL_LANES = 1e-6  # fleet lanes vs sessions (tests/test_serve_live.py:58-60)
LIVE_TOL_OFFLINE_DB = -110.0  # live vs offline (tests/test_live.py:24-54)
LIVE_SERVER_BLOCKS = 24  # blocks each server client reads
LIVE_REPLAY_RATE = 4.0  # replay_live's speed-up
LIVE_REPLAY_WALL = 2.5  # seconds of replay (10 s of the file)
FM_PLAIN_BLOCKS = 6  # blocks of the FM session held to the card's plain path


def block_times(times, block, sr, lanes):
    """Median, p99 and best block wall (ms) against the block's real-time
    budget, and sessions a card by bench.py:300's formula (lanes x budget /
    best block time) and by the median."""
    import numpy as np

    t = np.asarray(times[1:] if len(times) > 1 else times)  # the first warms up
    budget = block / sr
    out = {"median_ms": float(np.median(t)) * 1e3, "p99_ms": float(np.percentile(t, 99)) * 1e3,
           "best_ms": float(t.min()) * 1e3, "budget_ms": budget * 1e3,
           "sessions_bench": lanes * budget / float(t.min()),
           "sessions_median": lanes * budget / float(np.median(t))}
    return out


def check_fm_waveforms(fm, c, waveform, label):
    """K5 with a waveform a voice (an int32 tensor [V]) vs fm_feedback_ref:
    bit for bit in outputs and end states."""
    import torch

    args = (c["base"], FB, waveform, c["fb1"], c["fb2"])
    ok, f1k, f2k = fm.fm_feedback(*args)
    orf, f1r, f2r = fm.fm_feedback_ref(*args)
    torch.cuda.synchronize()
    same = torch.equal(ok, orf) and torch.equal(f1k, f1r) and torch.equal(f2k, f2r)
    V, n = ok.shape
    mix = sorted(set(waveform.reshape(-1).tolist()))
    print(f"  {label}: V={V} n={n} waveforms {mix} a voice: "
          f"{'bit-exact' if same else 'NOT bit-exact'}")
    if not same:
        raise AssertionError(f"{label}: K5 with a waveform a voice is not fm_feedback_ref")
    return float((ok - orf).abs().max())


def run_live(card, dev, rng, fm, filters, svf_cuda, lookup, k2, k2_emulated, k2_device,
             dense_err, dense_t, fm_err, fm_t, launches):
    """Phase 9b: K5 with a waveform a voice and K2 at the live shapes, then
    a LiveSession, an FMSynth session, fleets of 4, 64 and 256 lanes, a
    MultiInstrumentServer with four clients and replay_live, and a snapshot,
    on the card. Returns the live numbers for the kernels line."""
    import threading
    from unittest import mock

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from profile_torch import live_runner

    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.core.notes import NoteTracker
    from zang_tpu_torch.core.timeline import compile_timelines
    from zang_tpu_torch.graph.render import Performance, render_performance
    from zang_tpu_torch.host import instruments as ti
    from zang_tpu_torch.host import midi
    from zang_tpu_torch.host.live import LiveSession, push_tracked
    from zang_tpu_torch.host.song import SAMPLE_RATE, live_events
    from zang_tpu_torch.serve.live import LiveFleet
    from zang_tpu_torch.serve.server import LiveClient, MultiInstrumentServer, \
        builtin_instruments

    sr = SAMPLE_RATE
    out = {}
    gold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "live_golden_jax.npz"))
    gparams = json.loads(str(gold["params"]))

    # K5 with a waveform a voice: the fmsynth example's shape and a fleet's
    # (32 lanes x 4 voices x a 4096-frame block), every warp mixed, then
    # one waveform a warp (each warp uniform, the warps differing)
    print("K5 fm_feedback with a waveform a voice vs fm_feedback_ref (bit for bit):")
    for key, V, n in (("fmsynth", 8, 16384), ("fleet", 128, 4096)):
        c = fm_case(rng, V, n, dev)
        mixed = (torch.arange(V, device=dev) % 4).to(torch.int32)
        warps = ((torch.arange(V, device=dev) // 32) % 4).to(torch.int32)
        fm_err[f"{key} waveform a voice"] = max(
            check_fm_waveforms(fm, c, mixed, f"{key}, mixed in every warp"),
            check_fm_waveforms(fm, c, warps, f"{key}, one a warp"),
            check_fm(fm, c, torch.tensor(2, dtype=torch.int32, device=dev),
                     f"{key}, one waveform by pointer (stride 0)"))
        b = fm_bytes_ops(V, n)
        for form, w in (("stride 0", 2), ("stride 1, mixed", mixed)):
            args = (c["base"], FB, w, c["fb1"], c["fb2"])
            fm_t[f"{key} {form}"] = timing(
                card, f"{key} {form}, V={V} n={n}", lambda a=args: fm.fm_feedback(*a), None,
                "fm_feedback_kernel", *b, 10, 1)
    # K2 at the live shapes: a session's nice (4 voices x 1024), a fleet's at
    # 64 and 256 lanes (x 4 voices x 4096), the dense cutoff and the mask
    print(f"K2 at the live shapes vs svf_filter_ref (rms < {TOL_DB} dBFS):")
    for key, V, n in (("live session", 4, 1024), ("live fleet 64", 256, 4096),
                      ("live fleet 256", 1024, 4096)):
        a = dense_case(rng, V, n, "dense", True, dev)
        dense_err[key] = k2(f"{key} shape", a)
        k2_emulated(f"{key} shape", a)
        dense_t[key] = k2_device(f"{key} shape", a)

    def drive(render, pushes, trackers, block, blocks):
        audio, times = [], []
        for _ in range(blocks):
            t = time.perf_counter()
            for push, tr in zip(pushes, trackers):
                push_tracked(push, tr, sr, block)
            audio.append(render())
            times.append(time.perf_counter() - t)
        return np.concatenate(audio, axis=-1), times

    # the session: zang-serve's nice at LiveSession's block, the Toccata's first 10 s
    p = gparams["session"]
    block, blocks = p["block"], -(-int(p["seconds"] * sr) // p["block"])
    events = live_events(LIVE_SECONDS)
    s = LiveSession([(ti.NiceInstrument(p["color"]), p["polyphony"])], sr, block,
                    device="cuda")
    reset_counts(svf_cuda, lookup, fm)
    audio, times = drive(lambda: s.render_block(),
                         [lambda params, **kw: s.push_event(0, params, **kw)],
                         [NoteTracker(events)], block, blocks)
    launches["live_session"] = counts(svf_cuda, lookup, fm)
    if launches["live_session"] != expect_counts(svf_dense=blocks):
        raise AssertionError(f"live_session: launches {launches['live_session']}, "
                             f"expected one K2 a block ({blocks})")
    if not (np.isfinite(audio).all() and np.abs(audio).max() > 0.01):
        raise AssertionError("live_session: silent or not finite")
    out["session"] = block_times(times, block, sr, 1)
    total = audio.shape[-1]
    offline = render_performance(
        Performance([(ti.NiceInstrument(p["color"]), compile_timelines(
            events, p["polyphony"], sr, total))], sr), total, device="cuda").cpu().numpy()
    out["session_vs_offline_db"] = rms_db(audio, offline)
    print(f"live_session: {blocks} blocks of {block}, K2 {launches['live_session']['svf_dense']}"
          f"; vs the port's offline render {out['session_vs_offline_db']:.1f} dBFS "
          f"(< {LIVE_TOL_OFFLINE_DB}); block median {out['session']['median_ms']:.3f} ms, "
          f"p99 {out['session']['p99_ms']:.3f} ms of a {out['session']['budget_ms']:.1f} ms "
          f"budget [{card}]")
    if not out["session_vs_offline_db"] < LIVE_TOL_OFFLINE_DB:
        raise AssertionError("live_session: off the offline render")
    out["session_vs_jax_db"] = check_golden(gold["session_windows"], gold["session_offsets"],
                                            None, audio, "live_session")
    # snapshot on the card, restored into a fresh session: the same bits
    s2 = LiveSession([(ti.NiceInstrument(p["color"]), p["polyphony"])], sr, block,
                     device="cuda")
    s2.restore(s.snapshot())
    more = live_events(LIVE_SECONDS + 2.0, transpose=3)
    tail = [NoteTracker([e for e in more if e.t >= 0.5]) for _ in range(2)]
    a1, _ = drive(lambda: s.render_block(), [lambda params, **kw: s.push_event(0, params, **kw)],
                  tail[:1], block, 30)
    a2, _ = drive(lambda: s2.render_block(),
                  [lambda params, **kw: s2.push_event(0, params, **kw)], tail[1:], block, 30)
    if not np.array_equal(a1, a2):
        raise AssertionError("snapshot/restore on the card did not continue bit for bit")
    print("  snapshot on the card, restored into a fresh session: 30 blocks bit for bit")

    # the FMSynth session: device- and plan-kind parameter changes between blocks
    fm_blocks = 160

    def fm_session(blocks):
        fs = LiveSession([(ti.FMSynthInstrument(), 4)], sr, 1024, device="cuda")
        tr = NoteTracker(live_events(LIVE_SECONDS, transpose=-12))
        changes = {20: ("mod_waveform", 2), 40: ("mod_feedback", 5), 60: ("mod_attack", 3),
                   80: ("car_waveform", 1), 100: ("mod_waveform", 3), 120: ("algorithm", 0)}
        res = []
        for b in range(blocks):
            if b in changes:
                fs.set_param(0, *changes[b])
            push_tracked(lambda params, **kw: fs.push_event(0, params, **kw), tr, sr, 1024)
            res.append(fs.render_block())
        return np.concatenate(res, axis=-1)

    reset_counts(svf_cuda, lookup, fm)
    fm_audio = fm_session(fm_blocks)
    launches["live_fmsynth"] = counts(svf_cuda, lookup, fm)
    if launches["live_fmsynth"] != expect_counts(fm_feedback=fm_blocks):
        raise AssertionError(f"live_fmsynth: launches {launches['live_fmsynth']}, expected "
                             f"one K5 a block ({fm_blocks})")
    if not (np.isfinite(fm_audio).all() and np.abs(fm_audio).max() > 0.01):
        raise AssertionError("live_fmsynth: silent or not finite")
    with mock.patch.object(fm, "fm_feedback", fm.fm_feedback_ref):
        fm_plain = fm_session(FM_PLAIN_BLOCKS)
    same = np.array_equal(fm_audio[:, :fm_plain.shape[-1]], fm_plain)
    print(f"live_fmsynth: {fm_blocks} blocks, K5 {launches['live_fmsynth']['fm_feedback']}, "
          f"parameter changes at 6 blocks; the first {FM_PLAIN_BLOCKS} blocks vs the card's "
          f"plain path: {'bit-exact' if same else 'NOT bit-exact'}")
    if not same:
        raise AssertionError("live_fmsynth: not the plain path's bits")

    # fleets at bench_fleet's shape: 4, 64 and 256 lanes x nice x 4096-frame blocks
    pf = gparams["fleet"]
    fblock = pf["block"]
    fblocks = -(-int(pf["seconds"] * sr) // fblock)
    for L in LIVE_FLEET_LANES:
        render, n = live_runner(L, fblock, pf["seconds"])
        reset_counts(svf_cuda, lookup, fm)
        audio = render()
        key = f"live_fleet_{L}"
        launches[key] = counts(svf_cuda, lookup, fm)
        if launches[key] != expect_counts(svf_dense=n):
            raise AssertionError(f"{key}: launches {launches[key]}, expected one K2 a "
                                 f"block ({n})")
        if not (np.isfinite(audio).all() and np.abs(audio).max() > 0.01):
            raise AssertionError(f"{key}: silent or not finite")
        out[key] = block_times(render.times, fblock, sr, L)
        print(f"{key}: {n} blocks of {fblock}, K2 {launches[key]['svf_dense']} (one a block); "
              f"block median {out[key]['median_ms']:.3f} ms, p99 {out[key]['p99_ms']:.3f} ms, "
              f"best {out[key]['best_ms']:.3f} ms of a {out[key]['budget_ms']:.1f} ms budget; "
              f"sessions a card {out[key]['sessions_bench']:.0f} (bench.py's formula, best "
              f"block), {out[key]['sessions_median']:.0f} (median) [{card}]")
        if L == 4:
            out["fleet_vs_jax_db"] = max(
                check_golden(gold["fleet_windows"][:, lane], gold["fleet_offsets"], None,
                             audio[lane], f"live_fleet_4 lane {lane}")
                for lane in range(L))
            singles = []
            for lane in range(L):
                sl = LiveSession([(ti.NiceInstrument(pf["color"]), pf["polyphony"])], sr,
                                 fblock, device="cuda")
                a, _ = drive(lambda sl=sl: sl.render_block(),
                             [lambda params, sl=sl, **kw: sl.push_event(0, params, **kw)],
                             [NoteTracker(live_events(pf["seconds"], transpose=lane))],
                             fblock, fblocks)
                singles.append(a)
            out["fleet_vs_sessions"] = float(np.abs(audio - np.stack(singles)).max())
            print(f"  live_fleet_4 vs 4 sessions on the card: max |diff| "
                  f"{out['fleet_vs_sessions']:.3e} (<= {LIVE_TOL_LANES})")
            if not out["fleet_vs_sessions"] <= LIVE_TOL_LANES:
                raise AssertionError("live_fleet_4: lanes off their sessions")
        del render, audio

    # the server: MultiInstrumentServer with four clients playing at once and
    # a fifth replaying toccata.mid (the fleet grows to 8 lanes for it); each
    # client's PCM against a session fed the events its lane drained, at the
    # blocks it drained them, mixed down
    drained = {}  # session -> [(block start, [(impulse frame, note id, params)])]
    orig_extend = LiveSession._extend_segments

    def logged(self, part):
        iap = getattr(part, "_pending", None)
        if iap is not None and len(iap):
            drained.setdefault(self, []).append(
                (self.frame, [(imp.frame, imp.note_id, dict(prm))
                              for imp, prm in zip(iap.impulses, iap.paramses)]))
        return orig_extend(self, part)

    results, errors = {}, []
    # the block header's frame is lane 0's clock; a lane attached later
    # (the replayer's) runs its own, so each client reads the difference
    # while every lane is still attached, then all close together
    done = threading.Barrier(5, timeout=120)

    def lane_of(c):
        backend = srv.backend("nice")
        lane = c.welcome["lane"]
        with backend._lock:
            sess = backend.fleet.lanes[lane]
            return lane, sess, sess.frame - backend.fleet.lanes[0].frame

    with mock.patch.object(LiveSession, "_extend_segments", logged):
        srv = MultiInstrumentServer(builtin_instruments(sr, 4), port=0, initial_lanes=4,
                                    block_size=fblock, default_instrument="nice",
                                    device="cuda")
        srv.start()
        reset_counts(svf_cuda, lookup, fm)

        def player(i):
            try:
                c = LiveClient(srv.host, srv.port, timeout=60.0, instrument="nice")
                tr = NoteTracker(live_events(LIVE_SECONDS, transpose=2 * i))
                blocks, frames = [], []
                for _ in range(LIVE_SERVER_BLOCKS):
                    push_tracked(lambda params, note_id=None, impulse_frame=0:
                                 c.send_event(0, params, note_id=note_id), tr, sr, fblock)
                    blocks.append(c.read_block())
                    frames.append(c.last_block_frame)
                lane, sess, offset = lane_of(c)
                results[i] = (lane, blocks, [f + offset for f in frames], sess)
                done.wait()
                c.close()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"client {i}: {e!r}")
                done.abort()

        def replayer():
            try:
                c = LiveClient(srv.host, srv.port, timeout=60.0, instrument="nice")
                blocks, frames, stop = [], [], threading.Event()

                def reader():
                    while not stop.is_set():
                        blocks.append(c.read_block())
                        frames.append(c.last_block_frame)

                rt = threading.Thread(target=reader)
                rt.start()
                start = time.monotonic()

                class _Enough(Exception):
                    pass

                class Sender:
                    welcome = c.welcome
                    sent = 0

                    @staticmethod
                    def send_event(part, params, note_id=None):
                        if time.monotonic() - start > LIVE_REPLAY_WALL:
                            raise _Enough
                        c.send_event(part, params, note_id=note_id)
                        Sender.sent += 1

                with open(MIDI_FILE, "rb") as f:
                    data = f.read()
                try:
                    midi.replay_live(data, Sender, rate=LIVE_REPLAY_RATE)
                except _Enough:
                    pass
                time.sleep(0.5)
                stop.set()
                rt.join(timeout=30)
                lane, sess, offset = lane_of(c)
                results["replay"] = (lane, blocks, [f + offset for f in frames], sess,
                                     Sender.sent)
                done.wait()
                c.close()
            except Exception as e:  # noqa: BLE001
                errors.append(f"replay: {e!r}")
                done.abort()

        threads = [threading.Thread(target=player, args=(i,)) for i in range(4)]
        threads.append(threading.Thread(target=replayer))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        served = srv.backend("nice")._seq
        stats = srv.backend("nice").stats()
        srv.close()
    launches["live_server"] = counts(svf_cuda, lookup, fm)
    if errors:
        raise AssertionError(f"live server: {errors}")
    if launches["live_server"]["svf_dense"] != served or served == 0:
        raise AssertionError(f"live_server: {launches['live_server']} for {served} blocks")
    print(f"live_server: {served} blocks served, K2 {launches['live_server']['svf_dense']} "
          f"(one a block), {stats['lanes']} lanes; stats block median "
          f"{stats['block_time_ms']} ms of {stats['block_budget_ms']} ms [{card}]")
    worst = 0
    for key, (lane, blocks, frames, sess, *rest) in sorted(results.items(), key=str):
        pcm = np.concatenate(blocks, axis=1)
        if pcm.dtype != np.int16 or pcm.shape != (1, len(blocks) * fblock) or \
                not np.abs(pcm).max() > 100:
            raise AssertionError(f"client {key}: PCM {pcm.dtype} {pcm.shape}, peak "
                                 f"{np.abs(pcm).max()}")
        log = dict(drained.get(sess, []))
        ref = LiveSession([(ti.NiceInstrument(0.3), 4)], sr, fblock, device="cuda")
        ref_blocks = {}
        while ref.frame <= max(frames):
            for imp_frame, nid, prm in log.get(ref.frame, []):
                ref.push_event(0, prm, note_id=nid, impulse_frame=imp_frame)
            f0 = ref.frame
            ref_blocks[f0] = mixdown_s16_np(ref.render_block(), 0.5)
        want = np.concatenate([ref_blocks[f] for f in frames], axis=1)
        diff = int(np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max())
        worst = max(worst, diff)
        extra = f", {rest[0]} events replayed" if rest else ""
        print(f"  client {key} (lane {lane}): {len(blocks)} blocks from frame {frames[0]}, "
              f"peak {int(np.abs(pcm).max())}{extra}; vs a session fed its lane's events: "
              f"max |diff| {diff} LSB")
        if diff > 1:
            raise AssertionError(f"client {key}: {diff} LSB off its session")
    out["server_lsb"] = worst
    return out


# ---------------------------------------------------------------------------
# several devices: voice-sharded renders, one process a device, and the live
# fleet's lanes over devices (phase 12)

SHARD_TOL_DB = -120.0  # W ranks against one: the voice sum reordered (tests/test_parallel.py:45-47)
SHARD_TIMEOUT = 600.0  # seconds one launch of ranks may take
SHARD_POLY_VOICES = 16384  # poly_echo's voices in (a)-(c): bench_poly's largest
SHARD_POLY_SECONDS = 8.0
FLEET_LANES = 256  # zang-serve's cap; block 4096 (bench.py bench_fleet)
FLEET_SECONDS = 5.0  # the Toccata's first 5 s: 59 blocks a turn
# live_fleet_256's median and p99 block (ms) on an H100 at 700 W, PERF.md §5's table
FLEET_256_MS = (60.713, 166.279)


def song_golden():
    import numpy as np

    return np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "song_golden_jax.npz"))


def shard_jobs(tmp, tag, multiple):
    """The whole song (the merged organ) and poly_echo at SHARD_POLY_VOICES x
    8 s as RenderJobs, padded to `multiple`; rank 0 saves each mix in tmp."""
    import functools

    from zang_tpu_torch.host import configs, song
    from zang_tpu_torch.parallel import RenderJob, whole

    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    return [
        ("song", RenderJob(whole(functools.partial(song.song_build, total, multiple)), total,
                           CHUNK, os.path.join(tmp, f"{tag}_song.npy"))),
        (f"poly_echo_{SHARD_POLY_VOICES}",
         RenderJob(whole(functools.partial(configs.poly_echo_build, SHARD_POLY_VOICES,
                                           SHARD_POLY_SECONDS, multiple=multiple)),
                   int(SHARD_POLY_SECONDS * configs.SAMPLE_RATE), CHUNK,
                   os.path.join(tmp, f"{tag}_poly.npy"))),
    ]


def run_sharded(card, tag, mesh, launches, want, gold):
    """One launch of ranks over `mesh` (run_ranks with render_rank, as
    render_performance_sharded runs them) rendering the song and poly_echo.
    Each mix against the one-card render in `want` (bit for bit at one rank,
    else within SHARD_TOL_DB on every channel), the song also against the
    JAX golden windows; every rank's bits alike; each rank's kernel by its
    own voice count (filters.svf_table_route). The launches, summed over
    the ranks, go into `launches` as "<piece>_<tag>". Returns the ranks'
    numbers."""
    import tempfile

    import numpy as np

    from zang_tpu_torch.ops import filters
    from zang_tpu_torch.parallel import render_rank, run_ranks

    W = mesh.size
    where = ", ".join(str(d) for d in mesh.devices)
    with tempfile.TemporaryDirectory(prefix="zang_shard_") as tmp:
        jobs = shard_jobs(tmp, tag, W)
        t = time.perf_counter()
        stats = run_ranks(render_rank, mesh, [job for _, job in jobs], timeout=SHARD_TIMEOUT)
        wall = time.perf_counter() - t
        mixes = [np.load(job.out_path) for _, job in jobs]
    print(f"{tag}: {W} rank(s), one process each, on {where} through {mesh.backend}: the "
          f"song and poly_echo_{SHARD_POLY_VOICES} in {wall:.3f}s (the processes' start "
          f"included) [{card}]")
    out = {"ranks": W, "devices": [str(d) for d in mesh.devices], "backend": mesh.backend,
           "wall_s": wall}
    for i, ((name, job), mix) in enumerate(zip(jobs, mixes)):
        ranks = [r[i] for r in stats]
        total_launches = expect_counts()
        for r in ranks:
            V = max(r["voices"])
            kname = ("svf_onepass" if name.startswith("poly_echo")
                     and V >= filters.ONEPASS_V_MIN else "svf_table")
            n_chunks = -(-job.total_frames // job.chunk_size)
            got = dict(r["launches"])
            w = got.pop("tile_windows")
            n_w = SEGPROGRAMS["song" if name == "song" else "poly_echo"]
            if got != expect_counts(**{kname: n_chunks}) or w != n_w * n_chunks:
                raise AssertionError(f"{tag} {name} rank {r['rank']}: launches "
                                     f"{r['launches']}, expected {n_chunks} {kname} and "
                                     f"{n_w * n_chunks} tile_windows")
            # NCCL's all-reduce is captured with the chunk (GraphStep: the first
            # chunk eager, every later one a replay); gloo's keeps the eager step
            replays = r["counts"].get("graph.replays", 0)
            want_replays = n_chunks - 1 if mesh.backend == "nccl" else 0
            if replays != want_replays:
                raise AssertionError(f"{tag} {name} rank {r['rank']}: {replays} graph "
                                     f"replays, expected {want_replays}")
            peak = r["peak_gib"]
            print(f"  {name} rank {r['rank']} on {r['device']}: voices {r['voices']}, ran "
                  f"{kname} x {r['launches'][kname]}, {replays} graph replays; timelines "
                  f"{r['build_s']:.3f}s, plan {r['plan_s']:.3f}s, slice {r['slice_s']:.3f}s, "
                  f"render {r['render_s']:.3f}s, peak device memory {peak:.2f} GiB [{card}]")
            if not peak < 64.0:
                raise AssertionError(f"{tag} {name}: peak device memory {peak:.2f} GiB")
            for k, v in got.items():
                total_launches[k] += v
        launches[f"{name}_{tag}"] = total_launches
        if len({r["digest"] for r in ranks}) != 1:
            raise AssertionError(f"{tag} {name}: the ranks' mixes differ")
        if not np.isfinite(mix).all() or mix.shape != want[name].shape:
            raise AssertionError(f"{tag} {name}: {mix.shape}, or not finite")
        if W == 1:
            same = np.array_equal(mix, want[name])
            print(f"  {name}: {'bit for bit' if same else 'NOT bit for bit'} with the "
                  f"one-card render_performance (phase 7)")
            if not same:
                raise AssertionError(f"{tag} {name}: not render_performance's bits at one rank")
            dbs = [-np.inf]
        else:
            dbs = [rms_db(mix[ch], want[name][ch]) for ch in range(mix.shape[0])]
            print(f"  {name}: {max(dbs):.1f} dBFS from the one-card render (phase 7; bound "
                  f"{SHARD_TOL_DB}); the {W} ranks' mixes the same bits")
            if not max(dbs) < SHARD_TOL_DB:
                raise AssertionError(f"{tag} {name}: {max(dbs):.1f} dBFS from one card")
        if name == "song":
            check_golden(gold["windows"], gold["offsets"], gold["chunk_rms"], mix[0],
                         f"{tag} song")
        out[name] = {"vs_one_card_db": max(dbs), "ranks": [
            {k: r[k] for k in ("device", "voices", "build_s", "plan_s", "slice_s",
                               "render_s", "peak_gib", "launches")} for r in ranks]}
    return out


def run_lane_fleet(card, launches, devices):
    """(d): the live fleet at FLEET_LANES lanes, block 4096, the Toccata's
    first FLEET_SECONDS (phase 9b's live_fleet_256, shorter), on one device
    and with its lanes in a group a device of `devices`, in turns (one,
    groups, groups, one): one K2 a group and block, every block within
    LIVE_TOL_LANES of the one-device fleet's; block times beside PERF.md
    §5's."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from profile_torch import live_runner

    from zang_tpu_torch.host.song import SAMPLE_RATE
    from zang_tpu_torch.ops import fm, lookup, svf_cuda
    from zang_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=devices, axis="lanes")
    block = 4096
    audio, out = {}, {"devices": [str(d) for d in mesh.devices]}
    for turn, m in enumerate((None, mesh, mesh, None)):
        key = "one_group" if m is None else f"{m.size}_groups"
        render, n = live_runner(FLEET_LANES, block, FLEET_SECONDS, mesh=m)
        reset_counts(svf_cuda, lookup, fm)
        a = render()
        c = counts(svf_cuda, lookup, fm)
        groups = 1 if m is None else m.size
        if c != expect_counts(svf_dense=n * groups):
            raise AssertionError(f"live_fleet_{FLEET_LANES} {key}: launches {c}, expected "
                                 f"one K2 a group and block ({n * groups})")
        if m is not None and turn == 1:
            launches[f"live_fleet_{FLEET_LANES}_mesh"] = c
        if not (np.isfinite(a).all() and np.abs(a).max() > 0.01):
            raise AssertionError(f"live_fleet_{FLEET_LANES} {key}: silent or not finite")
        audio.setdefault(key, a)
        bt = block_times(render.times, block, SAMPLE_RATE, FLEET_LANES)
        out.setdefault(key, []).append(bt)
        print(f"live_fleet_{FLEET_LANES}, {key} ({', '.join(out['devices']) if m else 'cuda:0'}):"
              f" {n} blocks, K2 {c['svf_dense']} ({groups} a block); block median "
              f"{bt['median_ms']:.3f} ms, p99 {bt['p99_ms']:.3f} ms, best {bt['best_ms']:.3f} "
              f"ms of {bt['budget_ms']:.1f} (PERF.md §5's live_fleet_256: {FLEET_256_MS[0]} / "
              f"{FLEET_256_MS[1]} ms) [{card}]")
        del render, a
    keys = sorted(audio)
    diff = float(np.abs(audio[keys[0]] - audio[keys[1]]).max())
    out["max_abs_diff"] = diff
    print(f"  live_fleet_{FLEET_LANES}: {keys[1]} vs {keys[0]} over {n} blocks: max |diff| "
          f"{diff:.3e} (<= {LIVE_TOL_LANES})")
    if not diff <= LIVE_TOL_LANES:
        raise AssertionError(f"live_fleet_{FLEET_LANES}: the lane groups are off the fleet")
    return out


def run_multi_gpu(card, launches, song_mix, poly_mix):
    """Phase 12: (a) NCCL at one rank on cuda:0, bit for bit; (b) two gloo
    ranks on cuda:0; (c) NCCL over every card when there are two or more;
    (d) the lane-sharded live fleet. Returns its numbers."""
    import numpy as np
    import torch

    from zang_tpu_torch.parallel import make_mesh

    gold = song_golden()
    want = {"song": song_mix, f"poly_echo_{SHARD_POLY_VOICES}": poly_mix}
    torch.cuda.empty_cache()  # the ranks' processes share the card with this one
    out = {}
    mesh = make_mesh(1)
    if mesh.backend != "nccl":
        raise AssertionError(f"one card: backend {mesh.backend}")
    out["a_nccl_1"] = run_sharded(card, "a_nccl_1", mesh, launches, want, gold)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    print(f"(b): two ranks on one card (cuda:0, cuda:0), backend {mesh.backend}")
    if mesh.backend != "gloo":
        raise AssertionError(f"two ranks on one card: backend {mesh.backend}")
    out["b_gloo_2_one_card"] = run_sharded(card, "b_gloo_2", mesh, launches, want, gold)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        mesh = make_mesh(n_cards)
        out[f"c_nccl_{n_cards}"] = run_sharded(card, f"c_nccl_{n_cards}", mesh, launches,
                                               want, gold)
    else:
        print("(c): one card, so no NCCL run over distinct cards")
    fleet_devices = (["cuda:0", "cuda:0"] if n_cards < 2
                     else [f"cuda:{i}" for i in range(n_cards)])
    out["d_fleet"] = run_lane_fleet(card, launches, fleet_devices)
    return out


# ---------------------------------------------------------------------------
# the port's kernel tests on the card (phase 13), its bench and soak (phase 14)

CUDA_TESTS = ("tests/test_torch_cuda_kernels.py", "tests/test_torch_cuda_paths.py")
BENCH_SONG_SECONDS = 60.0
BENCH_POLY_VOICES, BENCH_POLY_SECONDS = 4096, 8.0
BENCH_SAMPLER_SECONDS = 10.0
BENCH_SERVE_SONGS, BENCH_SERVE_SECONDS = 2, 30.0
BENCH_FLEET_LANES = 64
BENCH_ENV = dict(ZANG_BENCH_SECONDS=str(BENCH_SONG_SECONDS),
                 ZANG_BENCH_POLY_VOICES=str(BENCH_POLY_VOICES),
                 ZANG_BENCH_POLY_SECONDS=str(BENCH_POLY_SECONDS),
                 ZANG_BENCH_SAMPLER_SECONDS=str(BENCH_SAMPLER_SECONDS),
                 ZANG_BENCH_SERVE_SONGS=str(BENCH_SERVE_SONGS),
                 ZANG_BENCH_SERVE_SECONDS=str(BENCH_SERVE_SECONDS),
                 ZANG_BENCH_SERVE_PASSES="1", ZANG_BENCH_FLEET_LANES=str(BENCH_FLEET_LANES),
                 ZANG_BENCH_IDLE_WAIT="0")
BENCH_METRICS = ("torch_sampler_chain_rtf_44k", "torch_poly_echo_voices_per_chip",
                 "torch_batch_serve_rtf_aggregate", "torch_live_fleet_sessions_per_chip",
                 "torch_bach_render_fidelity_rms_dbfs", "torch_bach_toccata_render_rtf_48k")
SOAK_SECONDS, SOAK_CLIENTS = 20.0, 2


def bench_launches():
    """Each bench metric's launches at BENCH_ENV's sizes: its chunks times
    its renders (a warm one and 3 timed; serve's warm job of 8 s and one
    pass; the fleet's warm block and 8 timed)."""
    chunks = lambda seconds, sr: -(-int(seconds * sr) // CHUNK)
    sampler = 4 * chunks(BENCH_SAMPLER_SECONDS, 44100.0)
    poly = 4 * chunks(BENCH_POLY_SECONDS, 44100.0)
    fidelity = chunks(BENCH_SONG_SECONDS, 48000.0)
    song4 = 4 * fidelity
    # W a SegProgram and chunk where the render takes window plans; serve's
    # shared step takes host slices (serve/batch.py), the fleet no programs
    return {
        "bench_sampler": {"table_lookup": sampler, "sampler_play": sampler,
                          "tile_windows": SEGPROGRAMS["sampler"] * sampler},
        "bench_poly": {"svf_onepass": poly, "tile_windows": SEGPROGRAMS["poly_echo"] * poly},
        "bench_serve": {"svf_table": chunks(8.0, 48000.0)
                        + BENCH_SERVE_SONGS * chunks(BENCH_SERVE_SECONDS, 48000.0)},
        "bench_fleet": {"svf_dense": 1 + 8},
        "bench_fidelity": {"svf_table": fidelity,
                           "tile_windows": SEGPROGRAMS["song"] * fidelity},
        "bench_song": {"svf_table": song4, "tile_windows": SEGPROGRAMS["song"] * song4},
    }


def cards_short(suite, cards) -> list:
    """The skipped cases of a junit suite that are NCCL rank cases asking
    for more cards than `cards` (tests/test_torch_cuda_paths.py
    test_nccl_ranks_*: "needs W cards"); every other skip counts against
    phase 13."""
    import re

    out = []
    for case in suite.iter("testcase"):
        for skip in case.findall("skipped"):
            m = re.search(r"needs (\d+) cards", skip.get("message", ""))
            if case.get("name", "").startswith("test_nccl_ranks") and m and int(m[1]) > cards:
                out.append(case.get("name"))
    return out


def run_bench_soak_tests(card):
    """Phases 13 and 14, each command in a subprocess from the repo root:
    the card's kernel tests beside the soak, then the bench alone. Returns
    their numbers."""
    import math
    import tempfile
    import xml.etree.ElementTree as ET

    import torch

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        junit = os.path.join(tmp, "cuda.xml")
        t = time.perf_counter()
        tests = subprocess.Popen(
            [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
             "-m", "cuda", "-q", f"--junitxml={junit}", *CUDA_TESTS],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            soak = subprocess.run(
                [sys.executable, "-m", "zang_tpu_torch.tools.soak", "--seconds",
                 str(SOAK_SECONDS), "--clients", str(SOAK_CLIENTS), "--json"],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
            test_log, _ = tests.communicate(timeout=900)
        finally:
            if tests.poll() is None:
                tests.kill()
                tests.wait()
        tests_s = time.perf_counter() - t
        # 13. the kernel tests
        suite = ET.parse(junit).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        n = {k: int(suite.get(k)) for k in ("tests", "errors", "failures", "skipped")}
        passed = n["tests"] - n["errors"] - n["failures"] - n["skipped"]
        fewer = cards_short(suite, torch.cuda.device_count())
        print(f"phase 13: {' '.join(CUDA_TESTS)} -m cuda --noconftest: {passed} of "
              f"{n['tests']} collected passed, {len(fewer)} skipped for want of cards "
              f"(rc {tests.returncode}, {tests_s:.1f}s beside the soak) [{card}]")
        if tests.returncode != 0 or not passed + len(fewer) == n["tests"] > 0:
            print(test_log[-6000:])
            raise AssertionError(f"phase 13: the card's kernel tests: {n}, rc {tests.returncode}")
        out["tests"] = dict(collected=n["tests"], passed=passed, seconds=round(tests_s, 1))
    # 14. the soak's report
    if soak.returncode != 0:
        print(soak.stdout[-4000:], soak.stderr[-4000:])
    report = json.loads(soak.stdout.strip().splitlines()[-1])
    print(f"phase 14: soak {SOAK_SECONDS:g} s, {SOAK_CLIENTS} clients: blocks "
          f"{report['blocks_per_client']}, churn drops {report['churn_drops']}, RSS growth "
          f"{report.get('rss_growth_mb')} MB, device memory growth "
          f"{report.get('device_growth_mb')} MB, failures {report['failures']} [{card}]")
    if soak.returncode != 0 or not report["ok"] or report["device"] != "cuda:0":
        raise AssertionError(f"phase 14: the soak failed: {report['failures']}")
    out["soak"] = {k: report.get(k) for k in (
        "blocks_per_client", "churn_drops", "stats_acks", "num_clients_at_end",
        "rss_growth_mb", "device_mb_end", "device_growth_mb", "wall_seconds")}
    # 14. the bench, alone on the card
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "zang_tpu_torch.bench"], cwd=ROOT,
                          env={**env, **BENCH_ENV}, capture_output=True, text=True,
                          timeout=900)
    bench_s = time.perf_counter() - t
    notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("# ")]
    print("\n".join(notes))
    if proc.returncode != 0:
        print(proc.stderr[-6000:])
        raise AssertionError(f"phase 14: the bench exited {proc.returncode}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    print("\n".join(json.dumps(ln) for ln in lines))
    if tuple(ln["metric"] for ln in lines) != BENCH_METRICS or \
            proc.stdout.strip().splitlines()[-1] != json.dumps(lines[-1]):
        raise AssertionError(f"phase 14: the bench printed {[ln['metric'] for ln in lines]}")
    if not all(math.isfinite(ln["value"]) and math.isfinite(ln["vs_baseline"])
               for ln in lines):
        raise AssertionError("phase 14: a metric is not finite")
    values = {ln["metric"]: ln["value"] for ln in lines}
    if not values["torch_bach_render_fidelity_rms_dbfs"] < PARITY_DB:
        raise AssertionError(f"phase 14: fidelity {values} over the parity budget")
    got = {}
    for ln in notes:  # "# bench_song launches {...} over ..."
        label, _, rest = ln[2:].partition(" launches ")
        if rest:
            got[label] = json.loads(rest.split(" over ")[0])
    if got != bench_launches():
        raise AssertionError(f"phase 14: the bench's launches {got}, expected "
                             f"{bench_launches()}")
    print(f"phase 14: the bench at a cut size in {bench_s:.1f}s, launches {got} [{card}]")
    out.update(metrics=values, launches=got, seconds=round(bench_s, 1),
               sizes={k[len("ZANG_BENCH_"):].lower(): v for k, v in BENCH_ENV.items()})
    return out


# ---------------------------------------------------------------------------
# the reference oracle on the card's host (phase 15)


def check_oracle(audio, ref, label):
    """audio, ref: f32 numpy [C, total] or [total]; every channel within the
    parity budget of the oracle's render over every frame."""
    import numpy as np

    return check_plain(np.atleast_2d(audio), np.atleast_2d(ref), label,
                       against=f"the oracle ({np.shape(ref)[-1]} frames)")


def run_oracle(card, svf_cuda, lookup, fm, launches, song_mix, song_window_db,
               sampler_mix, example_renders, flat_mix, poly_cuts):
    """Phase 15: the card's renders against the port's reference oracle on
    the host. song_mix: phase 7's song, f32 numpy [1, total];
    song_window_db: its worst reading on the JAX golden windows;
    sampler_mix: phase 7's 10 s sampler config [1, total]; example_renders:
    phase 9's renders by name; flat_mix: phase 7's song_flat [1, total];
    poly_cuts: phase 7's poly_echo renders' first frames by name
    (POLY_ORACLE_CUTS). Returns the phase's readings and the oracle's host
    seconds."""
    import hashlib
    import inspect
    import tempfile

    import numpy as np
    import torch

    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.core.notes import SongEvent
    from zang_tpu_torch.core.timeline import compile_timelines
    from zang_tpu_torch.core.wav import read_wav
    from zang_tpu_torch.graph.render import Performance, render_performance
    from zang_tpu_torch.host import configs, examples, song
    from zang_tpu_torch.oracle import examples as oex
    from zang_tpu_torch.oracle.script import render_script_oracle
    from zang_tpu_torch.script import compile_script
    from zang_tpu_torch.script.torch_backend import ScriptInstrument

    out = {"card": card, "host_seconds": {}}
    host_s = out["host_seconds"]  # the oracle's seconds, the host CPU's

    # (a) the song over every frame
    t = time.perf_counter()
    ref = song.render_song_oracle(song.NUM_SECONDS)
    host_s["song"] = time.perf_counter() - t
    print(f"phase 15 (a): render_song_oracle({song.NUM_SECONDS}) in {host_s['song']:.2f}s "
          f"of host CPU; the card's render (launches {launches['song']}):")
    out["song_db"] = check_oracle(song_mix, ref, "song")
    out["song_window_db"] = song_window_db
    print(f"  song: {out['song_db']:.1f} dBFS over all {ref.size} frames against the "
          f"oracle, {song_window_db:.1f} on the JAX golden's windows [{card}]")
    # (c1) the flat chunk format: the same reference, since the oracle has no chunks
    out["song_flat_db"] = check_oracle(
        flat_mix, ref, f"song_flat, chunk {SONG_FLAT_CHUNK} (launches {launches['song_flat']})")
    print(f"phase 15 (c1): song_flat {out['song_flat_db']:.1f} dBFS over all {ref.size} "
          f"frames against render_song_oracle({song.NUM_SECONDS}) [{card}]")
    del ref

    # (b) the twenty examples at their defaults, against their twins
    gold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "examples_golden_jax.npz"))
    out["examples_db"] = {}
    host_s["examples"] = {}
    for name, fn in examples.EXAMPLES.items():
        kw = {"warble_mul": gold["detuned_warble"]} if name == "detuned" else {}
        t = time.perf_counter()
        twin, _sr = fn(backend="oracle", **kw)
        host_s["examples"][name] = time.perf_counter() - t
        seconds = inspect.signature(fn).parameters["seconds"].default
        label = f"{name} ({seconds:g} s{', the JAX trajectory' if kw else ''}; launches " \
                f"{launches['ex_detuned_cascade' if kw else 'ex_' + name]})"
        out["examples_db"][name] = check_oracle(example_renders[name], twin, label)
    print(f"phase 15 (b): twenty twins in {sum(host_s['examples'].values()):.2f}s of host "
          f"CPU; worst {max(out['examples_db'].values()):.1f} dBFS [{card}]")

    # (c) the sampler config
    t = time.perf_counter()
    chain = oex.render_sampler_chain(10.0)
    host_s["sampler"] = time.perf_counter() - t
    out["sampler_db"] = check_oracle(sampler_mix, chain,
                                     f"sampler config 10 s (launches {launches['sampler']})")

    # (c2) poly_echo at 1024 and 4096 voices against the oracle twin, over a cut
    out["poly_echo_db"], host_s["poly_echo"] = {}, {}
    for name, (voices, seconds, frames) in POLY_ORACLE_CUTS.items():
        t = time.perf_counter()
        twin = configs.render_poly_echo_oracle(voices, seconds, frames=frames)
        host_s["poly_echo"][name] = time.perf_counter() - t
        out["poly_echo_db"][name] = check_oracle(
            poly_cuts[name], twin, f"{name} ({voices} voices, {seconds:g} s piece; launches "
            f"{launches[name]})")
        print(f"phase 15 (c2): {name}: the twin's first {frames} frames "
              f"({frames / configs.SAMPLE_RATE:g} s, {voices * frames} voice-samples) in "
              f"{host_s['poly_echo'][name]:.2f}s of host CPU "
              f"({voices * frames / host_s['poly_echo'][name] / 1e6:.2f} M a second); "
              f"{out['poly_echo_db'][name]:.1f} dBFS [{card}]")

    # (d) F2 on the card
    sr = 44100.0
    f2_song = []
    for i, (t0, dur, f) in enumerate(F2_NOTES):
        f2_song.append(SongEvent({"freq": f, "note_on": True}, t=t0, note_id=i + 1))
        f2_song.append(SongEvent({"freq": f, "note_on": False}, t=t0 + dur, note_id=i + 1))
    t = time.perf_counter()
    f2_ref = render_script_oracle(compile_script(F2_SCRIPT), "F2", f2_song, F2_TOTAL, sr)
    host_s["f2"] = time.perf_counter() - t
    out["f2_db"] = {}
    for chunk in (8192, 16384):
        tls = compile_timelines(f2_song, 1, sr, F2_TOTAL)
        perf = Performance([(ScriptInstrument(compile_script(F2_SCRIPT), "F2"), tls)], sr)
        reset_counts(svf_cuda, lookup, fm)
        audio = render_performance(perf, F2_TOTAL, chunk, device="cuda")
        torch.cuda.synchronize()
        got = counts(svf_cuda, lookup, fm)
        launches[f"f2_{chunk}"] = got
        if got != expect_counts(svf_dense=F2_TOTAL // F2_SUB):
            raise AssertionError(f"F2 at chunk {chunk}: launches {got}")
        out["f2_db"][chunk] = check_oracle(audio.cpu().numpy(), f2_ref,
                                           f"F2 at chunk {chunk} (launches {got})")

    # (e) the CLI's --engine oracle, a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "oracle.wav")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "zang_tpu_torch.host.render_wav", "song", wav,
             "--engine", "oracle", "--seconds", f"{ORACLE_CLI_SECONDS:g}"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"render_wav --engine oracle exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        w = read_wav(wav)
        pcm = np.frombuffer(w.data, "<i2")
    want = mixdown_s16_np(song.render_song_oracle(ORACLE_CLI_SECONDS)[None, :],
                          song.MIX_VOLUME)[0]
    if w.sample_rate != 48000 or w.num_channels != 1 or pcm.tobytes() != want.tobytes():
        raise AssertionError("render_wav --engine oracle: the WAV is not "
                             "render_song_oracle mixed down")
    host_s["cli"] = cli_s
    print(f"phase 15 (e): {proc.stdout.strip()} ({cli_s:.2f}s wall, the process's start "
          f"included): byte for byte render_song_oracle({ORACLE_CLI_SECONDS:g}) mixed down")

    # (f) the fingerprints, printed only
    with open(os.path.join(ROOT, "tests", "oracle_fingerprints.json")) as f:
        manifest = json.load(f)
    missed = []
    for name, seconds in FINGERPRINT_WINDOW.items():
        audio, sr_ = examples.EXAMPLES[name](seconds=seconds, backend="oracle")
        a = np.ascontiguousarray(np.asarray(audio, dtype=np.float32))
        h = hashlib.sha256()
        h.update(repr((a.shape, float(sr_))).encode())
        h.update(a.tobytes())
        if h.hexdigest() != manifest.get(name):
            missed.append(name)
    out["fingerprints"] = {"match": len(FINGERPRINT_WINDOW) - len(missed),
                           "of": len(FINGERPRINT_WINDOW), "mismatch": missed}
    print(f"phase 15 (f): oracle fingerprints {out['fingerprints']['match']} of "
          f"{len(FINGERPRINT_WINDOW)} match tests/oracle_fingerprints.json; mismatches: "
          f"{missed or 'none'} (printed only; detuned's trajectory is the port's own)")
    return out


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
    from zang_tpu_torch.host import configs, examples, midi, song
    from zang_tpu_torch.ops import _build, filters, fm, lookup, svf_cuda
    from zang_tpu_torch.ops import sampler as sampler_ops
    from zang_tpu_torch.oracle import native as oracle_native

    # 1. the card
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    dev = torch.device("cuda")

    # 2. build: one compiler process per source, all started together
    t = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        jobs = {f"{stem}.cu": pool.submit(_build.build, stem)
                for stem in ("svf_table", "svf_dense", "svf_onepass", "table_lookup",
                             "fm_feedback", "tile_windows")}
        jobs["zang_host.cpp"] = pool.submit(native.build)
        jobs["zang_oracle.cpp"] = pool.submit(oracle_native.build)
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

    # 4. K4 vs plain on the card: the fused entry, the two-tap entry, the generic one
    print("K4 sampler_play vs sampler_play_ref (bit for bit, every chunk):")
    lk_err = {"sampler": max(
        check_play(sampler_ops, lookup, play_programs(configs, case, chunk), chunk, dev,
                   f"{case} at chunk {chunk}")
        for case, chunk in (("config", CHUNK), ("config", ex_chunk),
                            *((c, CHUNK) for c in PLAY_CASES), ("long table, looped", CHUNK),
                            ("long table, one shot", CHUNK)))}
    lk_t = {}
    for key, chunk in (("sampler", CHUNK), ("sampler example", ex_chunk)):
        lk_t[key] = play_timing(card, sampler_ops, lookup, key, chunk, dev)
    print("K4 sampler_taps vs sampler_taps_ref and table_lookup vs table_lookup_ref "
          "(bit for bit):")
    n_drum = configs.SamplerInstrument().table.num_samples
    big = 128 * 2048
    sam_taps = taps_case(rng, n_drum, CHUNK, dev, -n_drum, 2 * n_drum)
    lk_err.update({
        "taps": max(
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
                         "generic, one-shot edges"))})
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
    for loop, key in ((True, "taps looped"), (False, "taps one shot")):
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
    lk_t["taps looped"].update(per_tap_ms=sum(p) / 2, per_tap_host_us=sum(ph) / 2)
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
    # the flat song's chunk (V=14 x 65,000, the organ's dense cutoff and mask)
    # and render_midi's filteredsaw part (its voices x 16,384, its cutoff, mask)
    song_total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    flat_case = flat_song_case(rng, song.build_performance(song_total), song_total, dev)
    with open(MIDI_FILE, "rb") as f:
        mixed, _ = midi.midi_performance(f.read(), midi_mixed_maker(midi),
                                         seconds=MIDI_MIXED_SECONDS)
    saw = MIDI_MIXED.index("filteredsaw")
    saw_case = dense_case(rng, len(mixed.parts[saw][1]), ex_chunk, "scalar", True, dev,
                          scalar_cut=mixed.programs[saw]["cutoff"])
    dense_err["song_flat"] = k2("flat song shape", flat_case)
    dense_err["midi filteredsaw"] = k2("midi filteredsaw shape", saw_case)
    # the zangscript shapes: the script example's delay sub-chunk (one
    # voice) and the midi_script parts' (the Toccata's peak polyphony, 8 and 2)
    script_cases = {key: script_case(rng, V, ex_chunk, dev)
                    for key, V in (("script", 1), ("midi_script v8", 8),
                                   ("midi_script v2", 2))}
    for key, a in script_cases.items():
        dense_err[key] = k2(f"{key} sub-chunk", a)
    for label, a in (("play shape", play_case), ("stereo shape", stereo_case),
                     ("detuned warble shape", warble_case),
                     ("detuned voice shape", voice_case), ("ragged shape", ragged_dense),
                     ("flat song shape", flat_case), ("midi filteredsaw shape", saw_case),
                     *((f"{key} sub-chunk", a) for key, a in script_cases.items())):
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
               "detuned warble": k2_device("detuned warble shape", warble_case),
               "song_flat": k2_time("flat song", flat_case, 100, 5),
               "midi filteredsaw": k2_time("midi filteredsaw", saw_case, 100, 10),
               **{key: k2_time(f"{key} sub-chunk", a, 100, 10)
                  for key, a in script_cases.items()}}
    play_cluster = svf_cuda.svf_dense_geometry(*play_case[2].shape).cluster
    print(f"  K2's latency floor at the play shape, an estimate: "
          f"{svf_chain_floor_us(play_cluster, mhz):.3f} us at {mhz:.0f} MHz, beside the "
          f"bytes bound {dense_t['play']['bound_ms'] * 1e3:.3f} us and the device time "
          f"{dense_t['play']['device_ms'] * 1e3:.1f} us [{card}]")
    del wide_case, chain, flat_case, mixed, script_cases

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
    onepass_err, onepass_t, k1_by_name = run_onepass(card, dev, rng, filters, svf_cuda, mhz)
    svf_err["router S=5"] = onepass_err.pop("router S=5")  # a K1 launch
    svf_t.update({k: v for k, v in k1_by_name.items() if k != "v1024"})

    # 6c. W vs its plain version on the card
    windows_err, windows_t = run_windows(card, dev)

    launches = {}
    windows = {}  # W's launches by main path

    # 7-8. the song
    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    reset_counts(svf_cuda, lookup, fm)
    t = time.perf_counter()
    pcm = song.render_song_s16(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches["song"] = counts(svf_cuda, lookup, fm)
    windows["song"], = launched("tile_windows")
    print(f"song: render_song_s16(device='cuda'): {pcm.shape[0]} frames in "
          f"{wall:.3f}s end to end (RTF {song.NUM_SECONDS / wall:.1f}), "
          f"launches {launches['song']}, W {windows['song']} [{card}]")
    if pcm.shape != (total,) or pcm.dtype != np.int16:
        raise AssertionError(f"pcm {pcm.shape} {pcm.dtype}, expected ({total},) int16")
    if launches["song"] != expect_counts(svf_table=-(-total // CHUNK)):
        raise AssertionError(f"song launches {launches['song']}")
    if windows["song"] != SEGPROGRAMS["song"] * -(-total // CHUNK):
        raise AssertionError(f"song: {windows['song']} W launches, expected one a "
                             f"program and chunk")
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
    song_window_db = check_golden(gold["windows"], gold["offsets"], gold["chunk_rms"],
                                  mix_np[0], "song")
    with mock.patch.object(filters, "svf_filter_table", filters.svf_filter_table_ref):
        plain = render_performance(perf, total, CHUNK, device="cuda").cpu().numpy()
    check_plain(mix_np, plain, "song")
    song_mix = mix_np
    del perf, mix, plain

    # 7-8. the sampler and poly_echo configs: (golden entry, config, seconds,
    # voices, the kernel each chunk launches and how often, frames of the
    # plain-path comparison or None)
    cgold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "configs_golden_jax.npz"))
    params = json.loads(str(cgold["params"]))
    if params["chunk_size"] != CHUNK:
        raise AssertionError("the configs' golden file is for another chunk size")
    plain_paths = {"sampler": (sampler_ops, "sampler_play", sampler_ops.sampler_play_ref),
                   "poly_echo": (filters, "svf_filter_table", filters.svf_filter_table_ref)}
    runs = [("sampler", "sampler", 10.0, None, "table_lookup", 1, "all"),
            ("poly_echo", "poly_echo", 30.0, 1024, "svf_table", 1, "all"),
            # the JAX package's capacity sizes (bench.py bench_poly); the
            # plain path's affine scan at 4096 voices fits one chunk
            ("poly_echo_4096", "poly_echo", 8.0, 4096, "svf_onepass", 1, CHUNK),
            ("poly_echo_16384", "poly_echo", 8.0, 16384, "svf_onepass", 1, None)]
    config_pcm = {}  # phase 11 holds the batch fleet's WAVs to these
    poly16_mix = None  # phase 12 holds the sharded renders to it
    poly_cuts = {}  # phase 15 (c2) holds these first frames to the oracle twin
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
        windows[name], = launched("tile_windows")
        print(f"{name}: render_config_s16({config!r}, {seconds}, device='cuda'"
              f"{''.join(f', {k}={v}' for k, v in kw.items())}): {pcm.shape} in "
              f"{wall:.3f}s end to end (RTF {seconds / wall:.1f}), "
              f"launches {launches[name]}, W {windows[name]} [{card}]")
        if pcm.shape != (channels, total) or pcm.dtype != np.int16:
            raise AssertionError(f"{name}: pcm {pcm.shape} {pcm.dtype}")
        if launches[name] != expect:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {expect}")
        if windows[name] != SEGPROGRAMS[config] * -(-total // CHUNK):
            raise AssertionError(f"{name}: {windows[name]} W launches, expected one a "
                                 f"program and chunk")
        if np.count_nonzero(pcm) < pcm.size // 2:
            raise AssertionError(f"the {name} render is mostly silent")
        if name != "poly_echo_16384":
            config_pcm[name] = pcm
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
        if name == "poly_echo_16384":
            poly16_mix = audio_np
        if name == "sampler":
            sampler_mix = audio_np  # phase 15 holds it to the oracle
            check_old_chain(audio_np, lambda: render_performance(perf, total, CHUNK,
                                                                 device="cuda"),
                            name, -(-total // CHUNK))
        if name in POLY_ORACLE_CUTS:
            poly_cuts[name] = np.ascontiguousarray(audio_np[:, :POLY_ORACLE_CUTS[name][2]])
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

    # 7, 7b, 8. the flat song, the Toccata as an SMF, the zang-midi CLI, streaming
    flat_mix = run_flat_midi_stream(card, filters, fm, lookup, svf_cuda, launches, song_mix)

    # 9. the examples
    example_renders = run_examples(examples, filters, fm, lookup, svf_cuda, card, launches)

    # 15. the reference oracle on the card's host: the song, the examples, the
    # sampler and F2 against it, over every frame
    oracle = run_oracle(card, svf_cuda, lookup, fm, launches, song_mix, song_window_db,
                        sampler_mix, example_renders, flat_mix, poly_cuts)
    del example_renders, sampler_mix, flat_mix, poly_cuts

    # 9b. live sessions, fleets and the TCP server
    live = run_live(card, dev, rng, fm, filters, svf_cuda, lookup, k2, k2_emulated, k2_device,
                    dense_err, dense_t, fm_err, fm_t, launches)

    # 11. the serving tiers: the batch fleet, a checkpointed render, HTTP, the visualizer
    serve = run_serve(card, filters, fm, lookup, svf_cuda, launches, song_mix, config_pcm)

    # 12. several devices: voice-sharded renders, one process a device, and the
    # live fleet's lanes over devices
    multi = run_multi_gpu(card, launches, song_mix, poly16_mix)
    del song_mix, config_pcm, poly16_mix

    # 13-14. the port's kernel tests on the card, its bench and its soak
    bench = run_bench_soak_tests(card)

    # 10. nothing of JAX
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zang_tpu"))
    if bad:
        raise AssertionError(f"modules of jax or zang_tpu were imported: {bad}")

    def kernel_row(name, source, replaces, errs, times, main_shape, counted=None):
        """One kernel's entry: the main shape's numbers at the top level,
        every shape's under "shapes", the launches of each main path
        (`counted`, by path, for W)."""
        by_path = ({path: n for path, n in counted.items() if n} if counted is not None
                   else {path: c[name] for path, c in launches.items() if c[name]})
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
        kernel_row("tile_windows", "tile_windows.cu", "zang_tpu/ops/segprog.py:92",
                   windows_err, windows_t, "poly_echo_4096.1", counted=windows),
    ]
    for r in rows:
        if not r["launches"]:
            raise AssertionError(f"{r['name']} was launched on no main path")
    print(json.dumps({"live": live}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"multi_gpu": multi}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"oracle": oracle}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
