"""Render the Bach Toccata with the JAX package and keep golden windows.

The PyTorch port (zang_tpu_torch) runs where JAX is not installed, so its
fidelity check against the JAX reference reads a small file instead of
rendering with JAX. This tool writes that file:

    zang_tpu_torch/data/song_golden_jax.npz
      offsets    int64 [W]       window start frames
      windows    f32   [W, 8192] the JAX f32 mix (pre-mixdown) at each offset
      chunk_rms  f64   [nc]      RMS of each 65536-frame render chunk
      total, chunk_size, window, sample_rate

The windows spread evenly over the song, plus windows that straddle chunk
boundaries (where the filter state carries across chunks) and the last
window of the final, partial chunk. Run from the repo root on the CPU:

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "zang_tpu_torch", "data", "song_golden_jax.npz")
WINDOW = 8192
CHUNK = 65536
N_SPREAD = 24
N_SEAMS = 10


def window_offsets(total: int, chunk: int = CHUNK, window: int = WINDOW) -> np.ndarray:
    """Evenly spread starts (the first at 0, the last ending at `total`)
    plus windows centred on chunk boundaries."""
    spread = np.linspace(0, total - window, N_SPREAD).astype(np.int64)
    n_chunks = -(-total // chunk)
    seams = np.linspace(1, n_chunks - 1, N_SEAMS).astype(np.int64) * chunk - window // 2
    offs = np.unique(np.concatenate([spread, seams]))
    return offs[(offs >= 0) & (offs + window <= total)]


def chunk_rms(mix: np.ndarray, chunk: int = CHUNK) -> np.ndarray:
    n_chunks = -(-mix.size // chunk)
    return np.array([
        np.sqrt(np.mean(mix[i * chunk:(i + 1) * chunk].astype(np.float64) ** 2))
        for i in range(n_chunks)
    ])


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from zang_tpu.host import song

    t = time.time()
    mix = song.render_song(song.NUM_SECONDS, chunk_size=CHUNK)
    print(f"rendered {mix.size} frames in {time.time() - t:.1f}s on the CPU")
    offs = window_offsets(mix.size)
    windows = np.stack([mix[o:o + WINDOW] for o in offs]).astype(np.float32)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, offsets=offs, windows=windows, chunk_rms=chunk_rms(mix),
        total=np.int64(mix.size), chunk_size=np.int64(CHUNK),
        window=np.int64(WINDOW), sample_rate=np.float64(song.SAMPLE_RATE),
    )
    print(f"wrote {OUT}: {len(offs)} windows, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
