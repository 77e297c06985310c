"""Render with the JAX package and keep golden windows for the PyTorch port.

The PyTorch port (zang_tpu_torch) runs where JAX is not installed, so its
fidelity check against the JAX reference reads small files instead of
rendering with JAX. This tool writes them:

    zang_tpu_torch/data/song_golden_jax.npz     (the 385 s Bach Toccata)
      offsets    int64 [W]       window start frames
      windows    f32   [W, 8192] the JAX f32 mix (pre-mixdown) at each offset
      chunk_rms  f64   [nc]      RMS of each 65536-frame render chunk
      total, chunk_size, window, sample_rate

    zang_tpu_torch/data/configs_golden_jax.npz  (sampler and poly_echo)
      params               str  JSON of each config's settings (seconds,
                                sample rate, voices, delay, seed, ...),
                                chunk size and window length
      <name>_offsets       int64 [W]
      <name>_windows       f32   [W, C, 4096]  the JAX f32 render [C, total]
      <name>_chunk_rms     f64   [C, nc]
    for <name> in sampler (10 s, C = 1) and poly_echo (1024 voices, 30 s,
    C = 2), at the JAX CLI's defaults, and poly_echo_4096 and
    poly_echo_16384 (that many voices, 8 s: bench.py's capacity sizes).
    The two large ones are rendered at a smaller JAX chunk (their
    "jax_chunk": the JAX render of 16384 voices at 65536 frames a chunk
    needs more memory than a 64 GB host has, and the audio depends on the
    chunk only through rounding); their chunk_rms is still on the 65536 grid.

    zang_tpu_torch/data/examples_golden_jax.npz (the twenty examples,
    zang_tpu_torch/host/examples.py EXAMPLES)
      params               str  JSON: each example's seconds, sample rate,
                                channels and render chunk, the window length
      <name>_offsets, <name>_windows [W, C, 4096], <name>_chunk_rms [C, nc]
                                as above, the RMS per render chunk of the
                                example (16384 frames; 65536 for the song)
    each at its default seconds (zang_tpu/host/examples.py). The detuned
    example's warble multiplier feeds a phase counter, so the port is held
    to it in two parts (zang_tpu/oracle/examples.py detuned_warble says
    why); for that the file also has
      detuned_warble        f32 [2, total]   exp2(4 * lowpass(white, 4 Hz)),
                                             the JAX trajectory
      detuned_warble_state  f32 [nc, 2, 2]   the 4 Hz filter's (l, b) of the
                                             two voices before each chunk

    zang_tpu_torch/data/song_flat_golden_jax.npz (the song in the flat chunk
    format: the JAX render_performance of the 385 s song at chunk 65,000)
      params     str  JSON: seconds, sample rate, chunk size, window length
      offsets, windows [W, 4096], chunk_rms [nc] (on the 65,000 grid)

    zang_tpu_torch/data/midi_golden_jax.npz (zang_tpu_torch/data/toccata.mid
    through the JAX render_midi)
      params     str  JSON: the file's SHA-256, the window length, and each
                      entry's instruments (cycled over the parts), seconds,
                      tail, sample rate, render chunk and total frames
      <name>_offsets, <name>_windows [W, C, 4096], <name>_chunk_rms [C, nc]
    for <name> in toccata (nice, at render_midi's defaults: the whole file
    plus 2 s of tail, chunk 16,384) and mixed (pmosc, filteredsaw and
    weirdsquare cycled over the three parts, 60 s).

    zang_tpu_torch/data/midi_script_golden_jax.npz (toccata.mid through the
    JAX render_midi with zangscript instrument
    zang_tpu_torch/data/demo_synth.txt:DemoSynth on every part, the whole
    file at render_midi's defaults)
      params     str  JSON: the SHA-256 of the MIDI file and of the script,
                      the window length, render_midi's settings, total frames
      offsets, windows [W, 1, 4096]   (windows only: no chunk RMS)

    zang_tpu_torch/data/live_golden_jax.npz (the JAX LiveSession and
    LiveFleet of zang-serve's default instrument, NiceInstrument(0.3) at
    polyphony 4, 48 kHz, fed zang_tpu_torch.host.song.live_events through a
    NoteTracker a block)
      params     str  JSON: each entry's seconds, block, lanes, polyphony,
                      color, sample rate, window and total frames
      session_offsets, session_windows [W, 1, 4096]   block 1024, one lane
      fleet_offsets, fleet_windows [W, 4, 1, 4096]    block 4096, 4 lanes
                                                      (lane l transposed
                                                      by l semitones)
    (windows only).

The windows spread evenly over the render, plus windows that straddle chunk
boundaries (where the state carries across chunks) and the last window of
the final, partial chunk. Run from the repo root on the CPU:

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [song|configs|examples|song_flat|midi|midi_script|live|all] [NAME ...]

The song takes about a minute, the examples a few minutes, midi_script
about ten minutes, the configs
about 40 minutes on 8 cores (poly_echo_16384 most of it, with ~20 GB
resident). Names after `configs` or `examples` remake only those entries and
keep the others from the file that is there.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DATA = os.path.join(ROOT, "zang_tpu_torch", "data")
OUT = os.path.join(DATA, "song_golden_jax.npz")
OUT_CONFIGS = os.path.join(DATA, "configs_golden_jax.npz")
OUT_EXAMPLES = os.path.join(DATA, "examples_golden_jax.npz")
OUT_SONG_FLAT = os.path.join(DATA, "song_flat_golden_jax.npz")
OUT_MIDI = os.path.join(DATA, "midi_golden_jax.npz")
OUT_MIDI_SCRIPT = os.path.join(DATA, "midi_script_golden_jax.npz")
OUT_LIVE = os.path.join(DATA, "live_golden_jax.npz")
MIDI_FILE = os.path.join(DATA, "toccata.mid")
SCRIPT_FILE = os.path.join(DATA, "demo_synth.txt")
WINDOW = 8192
CONFIG_WINDOW = 4096
CHUNK = 65536
N_SPREAD = 24
N_SEAMS = 10

# the JAX CLI's defaults (zang_tpu/host/render_wav.py)
CONFIGS = {
    "sampler": {"seconds": 10.0, "sample_rate": 44100.0, "speed": 1.0,
                "distort": True, "fake_sample_rate": 6000.0, "n_spread": 10,
                "n_seams": 4},
    "poly_echo": {"num_voices": 1024, "seconds": 30.0, "sample_rate": 44100.0,
                  "main_delay": 15000, "seed": 0, "n_spread": 12, "n_seams": 6},
    # bench.py's bench_poly sizes (16384 voices x 8 s is its default)
    "poly_echo_4096": {"num_voices": 4096, "seconds": 8.0, "sample_rate": 44100.0,
                       "main_delay": 15000, "seed": 0, "n_spread": 6, "n_seams": 5,
                       "jax_chunk": 16384},
    "poly_echo_16384": {"num_voices": 16384, "seconds": 8.0, "sample_rate": 44100.0,
                        "main_delay": 15000, "seed": 0, "n_spread": 6, "n_seams": 5,
                        "jax_chunk": 8192},
}


def window_offsets(total: int, chunk: int = CHUNK, window: int = WINDOW,
                   n_spread: int = N_SPREAD, n_seams: int = N_SEAMS) -> np.ndarray:
    """Evenly spread starts (the first at 0, the last ending at `total`)
    plus windows centred on chunk boundaries."""
    spread = np.linspace(0, total - window, n_spread).astype(np.int64)
    n_chunks = -(-total // chunk)
    seams = np.linspace(1, n_chunks - 1, n_seams).astype(np.int64) * chunk - window // 2
    offs = np.unique(np.concatenate([spread, seams]))
    return offs[(offs >= 0) & (offs + window <= total)]


def chunk_rms(mix: np.ndarray, chunk: int = CHUNK) -> np.ndarray:
    """RMS of each chunk along the last axis ([..., n] -> [..., nc])."""
    n_chunks = -(-mix.shape[-1] // chunk)
    return np.stack([
        np.sqrt(np.mean(mix[..., i * chunk:(i + 1) * chunk].astype(np.float64) ** 2,
                        axis=-1))
        for i in range(n_chunks)
    ], axis=-1)


def make_song():
    from zang_tpu.host import song

    t = time.time()
    mix = song.render_song(song.NUM_SECONDS, chunk_size=CHUNK)
    print(f"song: rendered {mix.size} frames in {time.time() - t:.1f}s on the CPU")
    offs = window_offsets(mix.size)
    windows = np.stack([mix[o:o + WINDOW] for o in offs]).astype(np.float32)
    np.savez_compressed(
        OUT, offsets=offs, windows=windows, chunk_rms=chunk_rms(mix),
        total=np.int64(mix.size), chunk_size=np.int64(CHUNK),
        window=np.int64(WINDOW), sample_rate=np.float64(song.SAMPLE_RATE),
    )
    print(f"wrote {OUT}: {len(offs)} windows, {os.path.getsize(OUT)} bytes")


def _build(name, p):
    from zang_tpu.host import configs

    if name == "sampler":
        return configs.build_sampler_performance(
            seconds=p["seconds"], sample_rate=p["sample_rate"], speed=p["speed"],
            distort=p["distort"], fake_sample_rate=p["fake_sample_rate"])
    return configs.build_poly_echo_performance(
        num_voices=p["num_voices"], seconds=p["seconds"],
        sample_rate=p["sample_rate"], main_delay=p["main_delay"], seed=p["seed"])


def _kept(path, only, names):
    """The arrays of the entries in `names` that are not remade now."""
    if not only:
        return {}
    unknown = sorted(set(only) - set(names))
    if unknown:
        raise SystemExit(f"unknown entries {unknown}; known: {sorted(names)}")
    old = np.load(path)
    return {k: old[k] for k in old.files
            if k != "params" and k.rsplit("_", 1 + k.endswith("chunk_rms"))[0] not in only}


def make_configs(only=()):
    from zang_tpu.graph.render import render_performance

    arrays = _kept(OUT_CONFIGS, only, CONFIGS)
    for name, p in CONFIGS.items():
        if only and name not in only:
            continue
        t = time.time()
        perf, total = _build(name, p)
        audio = np.asarray(render_performance(perf, total,
                                              chunk_size=p.get("jax_chunk", CHUNK)),
                           np.float32)  # [C, total]
        del perf
        print(f"{name}: rendered {audio.shape} in {time.time() - t:.1f}s on the CPU",
              flush=True)
        offs = window_offsets(total, window=CONFIG_WINDOW, n_spread=p["n_spread"],
                              n_seams=p["n_seams"])
        arrays[f"{name}_offsets"] = offs
        arrays[f"{name}_windows"] = np.stack(
            [audio[:, o:o + CONFIG_WINDOW] for o in offs])
        arrays[f"{name}_chunk_rms"] = chunk_rms(audio)
    params = {"chunk_size": CHUNK, "window": CONFIG_WINDOW, **CONFIGS}
    np.savez_compressed(OUT_CONFIGS, params=np.array(json.dumps(params, sort_keys=True)),
                        **arrays)
    print(f"wrote {OUT_CONFIGS}: {os.path.getsize(OUT_CONFIGS)} bytes")


# the port's examples (zang_tpu_torch/host/examples.py EXAMPLES) and the JAX
# package's render chunks for them (zang_tpu/host/examples.py)
EXAMPLE_NAMES = ("play", "arpeggiator", "polyphony", "portamento", "mouse", "fmsynth",
                 "sampler", "polyphony2", "delay", "song", "stereo", "detuned",
                 "envelope", "vibrato", "curve", "laser", "subsong", "two", "script",
                 "script_runtime")
EXAMPLE_CHUNK = 16384
SONG_EXAMPLE_CHUNK = 65536


def detuned_warble(V: int, total: int, sr: float, chunk: int):
    """The loop of zang_tpu/oracle/examples.py detuned_warble, keeping the
    filter state before each chunk too. Returns (multiplier [V, total],
    states [nc, 2, V])."""
    import jax
    import jax.numpy as jnp

    from zang_tpu.ops import filters
    from zang_tpu.ops import noise as noise_ops

    nl = nb = jnp.zeros((V,), jnp.float32)
    cut = filters.cutoff_from_frequency(jnp.float32(4.0), jnp.float32(sr))
    cols, states = [], []
    for c0 in range(0, total, chunk):
        states.append(np.stack([np.asarray(nl), np.asarray(nb)]))
        key = jax.random.fold_in(jax.random.PRNGKey(0xDE7), c0)
        white, _ = noise_ops.white_noise(key, (V, chunk))
        nl, nb, w = filters.svf_filter(nl, nb, white, "low_pass", cut, 0.0)
        cols.append(np.asarray(jnp.exp2(w * jnp.float32(4.0)))[:, :min(chunk, total - c0)])
    return np.concatenate(cols, axis=1), np.stack(states)


def make_examples(only=()):
    import inspect

    from zang_tpu.host import examples

    arrays, params = _kept(OUT_EXAMPLES, only, EXAMPLE_NAMES), {}
    if only:
        params = json.loads(str(np.load(OUT_EXAMPLES)["params"]))["examples"]
    for name in EXAMPLE_NAMES:
        if only and name not in only:
            continue
        fn = examples.EXAMPLES[name]
        seconds = inspect.signature(fn).parameters["seconds"].default
        t = time.time()
        audio, sr = fn(seconds=seconds)
        audio = np.asarray(audio, np.float32)  # [C, total]
        print(f"{name}: rendered {audio.shape} in {time.time() - t:.1f}s on the CPU")
        chunk = SONG_EXAMPLE_CHUNK if name == "song" else EXAMPLE_CHUNK
        total = audio.shape[-1]
        offs = window_offsets(total, chunk=chunk, window=CONFIG_WINDOW, n_spread=5,
                              n_seams=3)
        arrays[f"{name}_offsets"] = offs
        arrays[f"{name}_windows"] = np.stack([audio[:, o:o + CONFIG_WINDOW] for o in offs])
        arrays[f"{name}_chunk_rms"] = chunk_rms(audio, chunk)
        params[name] = {"seconds": float(seconds), "sample_rate": float(sr),
                        "channels": int(audio.shape[0]), "chunk_size": chunk}
        if name == "detuned":
            from zang_tpu.oracle import examples as oex

            mul, states = detuned_warble(2, total, sr, chunk)
            if not np.array_equal(mul, oex.detuned_warble(2, total, sr, chunk)):
                raise AssertionError("the warble loop is not the oracle twin's")
            arrays["detuned_warble"] = mul.astype(np.float32)
            arrays["detuned_warble_state"] = states.astype(np.float32)
    np.savez_compressed(
        OUT_EXAMPLES, params=np.array(json.dumps(
            {"window": CONFIG_WINDOW, "examples": params}, sort_keys=True)),
        **arrays)
    print(f"wrote {OUT_EXAMPLES}: {os.path.getsize(OUT_EXAMPLES)} bytes")


SONG_FLAT_CHUNK = 65000  # not a whole number of 512-frame tiles: the flat format


def make_song_flat():
    from zang_tpu.graph.render import render_performance
    from zang_tpu.host import song

    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    t = time.time()
    mix = np.asarray(render_performance(song.build_performance(total), total,
                                        chunk_size=SONG_FLAT_CHUNK), np.float32)[0]
    print(f"song_flat: rendered {mix.size} frames in {time.time() - t:.1f}s on the CPU")
    offs = window_offsets(total, chunk=SONG_FLAT_CHUNK, window=CONFIG_WINDOW, n_spread=12,
                          n_seams=6)
    params = {"seconds": song.NUM_SECONDS, "sample_rate": song.SAMPLE_RATE,
              "chunk_size": SONG_FLAT_CHUNK, "window": CONFIG_WINDOW, "total": total}
    np.savez_compressed(
        OUT_SONG_FLAT, params=np.array(json.dumps(params, sort_keys=True)), offsets=offs,
        windows=np.stack([mix[o:o + CONFIG_WINDOW] for o in offs]),
        chunk_rms=chunk_rms(mix, SONG_FLAT_CHUNK))
    print(f"wrote {OUT_SONG_FLAT}: {len(offs)} windows, {os.path.getsize(OUT_SONG_FLAT)} bytes")


# render_midi's settings of each midi entry; seconds None = the whole file
MIDI = {"toccata": {"instruments": ["nice"], "seconds": None, "tail": 2.0,
                    "sample_rate": 48000.0, "chunk_size": 16384, "n_spread": 10,
                    "n_seams": 6},
        "mixed": {"instruments": ["pmosc", "filteredsaw", "weirdsquare"], "seconds": 60.0,
                  "tail": 2.0, "sample_rate": 48000.0, "chunk_size": 16384,
                  "n_spread": 6, "n_seams": 4}}


def file_sha256(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def midi_sha256() -> str:
    return file_sha256(MIDI_FILE)


def make_midi():
    from zang_tpu.host import midi

    with open(MIDI_FILE, "rb") as f:
        data = f.read()
    arrays, params = {}, {"sha256": midi_sha256(), "window": CONFIG_WINDOW}
    for name, p in MIDI.items():
        makers = [midi.stock_instruments()[i] for i in p["instruments"]]
        t = time.time()
        audio = np.asarray(midi.render_midi(
            data, lambda pi, label, m=makers: m[pi % len(m)](), sample_rate=p["sample_rate"],
            seconds=p["seconds"], tail=p["tail"], chunk_size=p["chunk_size"]), np.float32)
        print(f"midi {name}: rendered {audio.shape} in {time.time() - t:.1f}s on the CPU",
              flush=True)
        total = audio.shape[-1]
        chunk = min(p["chunk_size"], max(256, total))
        offs = window_offsets(total, chunk=chunk, window=CONFIG_WINDOW,
                              n_spread=p["n_spread"], n_seams=p["n_seams"])
        arrays[f"{name}_offsets"] = offs
        arrays[f"{name}_windows"] = np.stack([audio[:, o:o + CONFIG_WINDOW] for o in offs])
        arrays[f"{name}_chunk_rms"] = chunk_rms(audio, chunk)
        params[name] = {**{k: v for k, v in p.items() if not k.startswith("n_")},
                        "total": total, "render_chunk": chunk}
    np.savez_compressed(OUT_MIDI, params=np.array(json.dumps(params, sort_keys=True)),
                        **arrays)
    print(f"wrote {OUT_MIDI}: {os.path.getsize(OUT_MIDI)} bytes")


# render_midi's settings of the midi_script entry (the whole file)
MIDI_SCRIPT = {"module": "DemoSynth", "seconds": None, "tail": 2.0, "sample_rate": 48000.0,
               "chunk_size": 16384, "n_spread": 10, "n_seams": 6}


def make_midi_script():
    from zang_tpu.host import midi

    with open(MIDI_FILE, "rb") as f:
        data = f.read()
    p = MIDI_SCRIPT
    maker = midi._instrument_maker(f"{SCRIPT_FILE}:{p['module']}")
    t = time.time()
    audio = np.asarray(midi.render_midi(
        data, lambda pi, label: maker(), sample_rate=p["sample_rate"], seconds=p["seconds"],
        tail=p["tail"], chunk_size=p["chunk_size"]), np.float32)
    print(f"midi_script: rendered {audio.shape} in {time.time() - t:.1f}s on the CPU",
          flush=True)
    total = audio.shape[-1]
    offs = window_offsets(total, chunk=p["chunk_size"], window=CONFIG_WINDOW,
                          n_spread=p["n_spread"], n_seams=p["n_seams"])
    params = {**{k: v for k, v in p.items() if not k.startswith("n_")},
              "midi_sha256": midi_sha256(), "script_sha256": file_sha256(SCRIPT_FILE),
              "window": CONFIG_WINDOW, "total": total}
    np.savez_compressed(OUT_MIDI_SCRIPT, params=np.array(json.dumps(params, sort_keys=True)),
                        offsets=offs,
                        windows=np.stack([audio[:, o:o + CONFIG_WINDOW] for o in offs]))
    print(f"wrote {OUT_MIDI_SCRIPT}: {os.path.getsize(OUT_MIDI_SCRIPT)} bytes")


# the live entries: zang-serve's default spec at LiveSession's default block
# (one lane) and at bench.py bench_fleet's block (4 lanes)
LIVE = {"session": {"seconds": 10.0, "block": 1024, "lanes": 1, "polyphony": 4,
                    "color": 0.3, "sample_rate": 48000.0, "n_windows": 8},
        "fleet": {"seconds": 10.0, "block": 4096, "lanes": 4, "polyphony": 4,
                  "color": 0.3, "sample_rate": 48000.0, "n_windows": 8}}


def render_live_jax(p):
    """The JAX session (lanes 1: [1, C, total]) or fleet ([L, C, total]) of
    a LIVE entry, fed live_events (lane l transposed by l) a block."""
    from zang_tpu.core.notes import NoteTracker
    from zang_tpu.host import instruments as ji
    from zang_tpu.host.live import LiveSession
    from zang_tpu.serve.live import LiveFleet
    from zang_tpu_torch.host.live import push_tracked
    from zang_tpu_torch.host.song import live_events

    sr, block, L = p["sample_rate"], p["block"], p["lanes"]
    parts = lambda: [(ji.NiceInstrument(p["color"]), p["polyphony"])]  # noqa: E731
    trackers = [NoteTracker(live_events(p["seconds"], transpose=lane)) for lane in range(L)]
    if L == 1:
        s = LiveSession(parts(), sr, block)
        pushes = [lambda params, **kw: s.push_event(0, params, **kw)]
        render = lambda: s.render_block()[None]  # noqa: E731
    else:
        fleet = LiveFleet(parts, L, sr, block_size=block)
        pushes = [lambda params, lane=lane, **kw: fleet.push_event(lane, 0, params, **kw)
                  for lane in range(L)]
        render = fleet.render_block
    out = []
    for _ in range(-(-int(p["seconds"] * sr) // block)):
        for push, tr in zip(pushes, trackers):
            push_tracked(push, tr, sr, block)
        out.append(np.asarray(render(), np.float32))
    return np.concatenate(out, axis=-1)


def make_live():
    arrays, params = {}, {"window": CONFIG_WINDOW}
    for name, p in LIVE.items():
        t = time.time()
        audio = render_live_jax(p)
        if p["lanes"] == 1:
            audio = audio[0]
        print(f"live {name}: rendered {audio.shape} in {time.time() - t:.1f}s on the CPU",
              flush=True)
        total = audio.shape[-1]
        offs = np.linspace(0, total - CONFIG_WINDOW, p["n_windows"]).astype(np.int64)
        arrays[f"{name}_offsets"] = offs
        arrays[f"{name}_windows"] = np.stack([audio[..., o:o + CONFIG_WINDOW] for o in offs])
        params[name] = {**{k: v for k, v in p.items() if not k.startswith("n_")},
                        "total": total}
    np.savez_compressed(OUT_LIVE, params=np.array(json.dumps(params, sort_keys=True)),
                        **arrays)
    print(f"wrote {OUT_LIVE}: {os.path.getsize(OUT_LIVE)} bytes")


def main(argv=None):
    import jax

    which, *only = argv or sys.argv[1:] or ["all"]
    if which not in ("song", "configs", "examples", "song_flat", "midi", "midi_script",
                     "live", "all") or (only and which not in ("configs", "examples")):
        raise SystemExit(f"usage: {sys.argv[0]} "
                         "[song|configs|examples|song_flat|midi|midi_script|live|all] "
                         "[NAME ...]")
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(DATA, exist_ok=True)
    if which in ("song", "all"):
        make_song()
    if which in ("configs", "all"):
        make_configs(only)
    if which in ("examples", "all"):
        make_examples(only)
    if which in ("song_flat", "all"):
        make_song_flat()
    if which in ("midi", "all"):
        make_midi()
    if which in ("midi_script", "all"):
        make_midi_script()
    if which in ("live", "all"):
        make_live()


if __name__ == "__main__":
    main()
