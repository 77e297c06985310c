"""Visualization data: waveform, FFT spectrum, frequency-synced oscilloscope.

The data-level port of the reference's software visualizer
(examples/visual.zig: DrawSpectrum/DrawWaveform/DrawOscilloscope fed 1024
samples per block, examples/common/fft.zig: iterative radix-2 FFT used at
512 points). SDL rendering is out of scope for an offline framework; these
produce the same frame data (numpy arrays) the widgets would draw, suitable
for tests, dumps, or plotting.
"""

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def fft_radix2(re: np.ndarray, im: np.ndarray) -> None:
    """In-place iterative radix-2 FFT (examples/common/fft.zig:25-60 port:
    bit-reversal permutation + butterfly passes, f32)."""
    n = len(re)
    assert n and (n & (n - 1)) == 0, "power of two"
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            re[i], re[j] = re[j], re[i]
            im[i], im[j] = im[j], im[i]
    length = 2
    while length <= n:
        ang = -2.0 * np.pi / length
        wl_re, wl_im = np.cos(ang), np.sin(ang)
        for i in range(0, n, length):
            w_re, w_im = 1.0, 0.0
            for k in range(length // 2):
                a, b = i + k, i + k + length // 2
                u_re, u_im = re[a], im[a]
                v_re = re[b] * w_re - im[b] * w_im
                v_im = re[b] * w_im + im[b] * w_re
                re[a], im[a] = u_re + v_re, u_im + v_im
                re[b], im[b] = u_re - v_re, u_im - v_im
                w_re, w_im = w_re * wl_re - w_im * wl_im, w_re * wl_im + w_im * wl_re
        length <<= 1


def spectrum_frame(samples: np.ndarray, fft_size: int = 512,
                   log_scale: bool = True) -> np.ndarray:
    """Magnitude spectrum of the first fft_size samples (DrawSpectrum's
    data: |FFT| over the positive bins, optionally logarithmically mapped)."""
    x = np.asarray(samples[:fft_size], dtype=np.float64)
    if len(x) < fft_size:
        x = np.pad(x, (0, fft_size - len(x)))
    re = x.copy()
    im = np.zeros(fft_size)
    fft_radix2(re, im)
    mag = np.sqrt(re * re + im * im)[: fft_size // 2]
    if log_scale:
        mag = np.log1p(mag)
    return mag


def waveform_frame(samples: np.ndarray, width: int = 512) -> np.ndarray:
    """Min/max envelope per pixel column (DrawWaveform): [width, 2]."""
    x = np.asarray(samples, dtype=np.float32)
    n = len(x)
    cols = np.zeros((width, 2), dtype=np.float32)
    for c in range(width):
        lo = c * n // width
        hi = max((c + 1) * n // width, lo + 1)
        seg = x[lo:hi]
        cols[c] = (seg.min(), seg.max())
    return cols


def oscilloscope_frame(samples: np.ndarray, sync_freq: Optional[float],
                       sample_rate: float, width: int = 512) -> np.ndarray:
    """Frequency-synced single-cycle window (DrawOscilloscope with the
    output_sync_oscilloscope channel): start at the first upward zero
    crossing, span one period of sync_freq (or the raw window)."""
    x = np.asarray(samples, dtype=np.float32)
    start = 0
    for i in range(1, len(x)):
        if x[i - 1] <= 0.0 < x[i]:
            start = i
            break
    if sync_freq and sync_freq > 0:
        period = int(round(sample_rate / sync_freq))
        period = max(2, min(period, len(x) - start))
    else:
        period = len(x) - start
    window = x[start : start + period]
    # resample to width columns (nearest)
    idx = np.minimum((np.arange(width) * len(window)) // width, len(window) - 1)
    return window[idx]


@dataclass
class Visuals:
    """Streaming visualizer state: feed audio block by block (the audio
    callback's visuals.newInput flow, examples/example.zig:71-82)."""

    sample_rate: float
    block_size: int = 1024
    fft_size: int = 512

    def frames(self, audio: np.ndarray,
               sync: Optional[np.ndarray] = None) -> Iterator[dict]:
        """Yield one frame dict per block: waveform/spectrum/oscilloscope."""
        n = len(audio)
        for start in range(0, n - self.block_size + 1, self.block_size):
            block = audio[start : start + self.block_size]
            sync_freq = None
            if sync is not None:
                f = float(np.max(sync[start : start + self.block_size]))
                sync_freq = f if f > 0 else None
            yield {
                "start": start,
                "waveform": waveform_frame(block),
                "spectrum": spectrum_frame(block, self.fft_size),
                "oscilloscope": oscilloscope_frame(
                    block, sync_freq, self.sample_rate),
            }


# ---------------------------------------------------------------------------
# Offline rendering layer (the visual.zig widget/UI analog): turn a WAV into
# an inspectable PNG — waveform, spectrogram, spectrum area chart, and the
# frequency-synced oscilloscope, with a small built-in bitmap font
# (visual.zig:205-791 drawing, :7-9,795 bitmap font; PNG instead of SDL).

import struct
import zlib

# 5x7 bitmap font, one glyph = 7 rows of 5-bit patterns (MSB = left column).
_FONT = {
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    "A": (0x0E, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "B": (0x1E, 0x11, 0x11, 0x1E, 0x11, 0x11, 0x1E),
    "C": (0x0E, 0x11, 0x10, 0x10, 0x10, 0x11, 0x0E),
    "D": (0x1C, 0x12, 0x11, 0x11, 0x11, 0x12, 0x1C),
    "E": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x1F),
    "F": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x10),
    "G": (0x0E, 0x11, 0x10, 0x17, 0x11, 0x11, 0x0F),
    "H": (0x11, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "I": (0x0E, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "J": (0x07, 0x02, 0x02, 0x02, 0x02, 0x12, 0x0C),
    "K": (0x11, 0x12, 0x14, 0x18, 0x14, 0x12, 0x11),
    "L": (0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x1F),
    "M": (0x11, 0x1B, 0x15, 0x15, 0x11, 0x11, 0x11),
    "N": (0x11, 0x19, 0x15, 0x13, 0x11, 0x11, 0x11),
    "O": (0x0E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "P": (0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10),
    "Q": (0x0E, 0x11, 0x11, 0x11, 0x15, 0x12, 0x0D),
    "R": (0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11),
    "S": (0x0F, 0x10, 0x10, 0x0E, 0x01, 0x01, 0x1E),
    "T": (0x1F, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04),
    "U": (0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "V": (0x11, 0x11, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "W": (0x11, 0x11, 0x11, 0x15, 0x15, 0x1B, 0x11),
    "X": (0x11, 0x11, 0x0A, 0x04, 0x0A, 0x11, 0x11),
    "Y": (0x11, 0x11, 0x0A, 0x04, 0x04, 0x04, 0x04),
    "Z": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x10, 0x1F),
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C),
    ":": (0x00, 0x0C, 0x0C, 0x00, 0x0C, 0x0C, 0x00),
    "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
    "+": (0x00, 0x04, 0x04, 0x1F, 0x04, 0x04, 0x00),
    "/": (0x01, 0x01, 0x02, 0x04, 0x08, 0x10, 0x10),
    "%": (0x19, 0x19, 0x02, 0x04, 0x08, 0x13, 0x13),
    " ": (0, 0, 0, 0, 0, 0, 0),
}


def write_png(path: str, rgb: "np.ndarray") -> None:
    """Minimal PNG writer (8-bit RGB, stdlib only). rgb: uint8 [h, w, 3]."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def draw_text(img: "np.ndarray", x: int, y: int, text: str, color) -> None:
    """Draw 5x7 bitmap text (uppercased; unknown glyphs become spaces)."""
    for ch in text.upper():
        rows = _FONT.get(ch, _FONT[" "])
        for r, bits in enumerate(rows):
            for c in range(5):
                if bits & (0x10 >> c):
                    yy, xx = y + r, x + c
                    if 0 <= yy < img.shape[0] and 0 <= xx < img.shape[1]:
                        img[yy, xx] = color
        x += 6


def _panel(img, x0, y0, w, h, title, color=(150, 155, 170)):
    img[y0 : y0 + h, x0] = (45, 48, 60)
    img[y0 : y0 + h, x0 + w - 1] = (45, 48, 60)
    img[y0, x0 : x0 + w] = (45, 48, 60)
    img[y0 + h - 1, x0 : x0 + w] = (45, 48, 60)
    draw_text(img, x0 + 4, y0 - 10, title, color)


def _spectrogram_color(v: "np.ndarray") -> "np.ndarray":
    """v in [0,1] -> dark blue -> magenta -> yellow ramp, uint8 [..., 3]."""
    v = np.clip(v, 0.0, 1.0)
    r = np.clip(3.0 * v - 0.6, 0, 1)
    g = np.clip(2.2 * v - 1.2, 0, 1)
    b = np.clip(1.8 * v + 0.08, 0, 1) * np.clip(2.0 - 2.2 * v, 0.25, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def render_image(audio: "np.ndarray", sample_rate: float,
                 width: int = 1024, title: str = "") -> "np.ndarray":
    """Render mono audio to an inspection image: full-length waveform,
    block spectrogram, loudest-block spectrum area chart + synced
    oscilloscope. Returns uint8 [h, w, 3]."""
    x = np.asarray(audio, dtype=np.float32)
    n = len(x)
    W = width
    pad, head = 10, 16
    wf_h, sg_h, sp_h, os_h = 140, 180, 110, 110
    gap = 24
    H = head + wf_h + sg_h + sp_h + os_h + 5 * gap
    img = np.zeros((H, W, 3), dtype=np.uint8)
    img[:] = (17, 19, 26)
    inner_w = W - 2 * pad

    peak = float(np.max(np.abs(x))) if n else 0.0
    rms = float(np.sqrt(np.mean(x.astype(np.float64) ** 2))) if n else 0.0
    db = lambda v: 20 * np.log10(max(v, 1e-9))
    draw_text(img, pad, 4,
              f"{title}  {n / sample_rate:.2f}S {int(sample_rate)}HZ  "
              f"PEAK {db(peak):.1f} RMS {db(rms):.1f} DBFS", (210, 214, 228))

    # waveform (full length, min/max envelope per column)
    y0 = head + gap
    _panel(img, pad - 1, y0 - 1, inner_w + 2, wf_h + 2, "WAVEFORM")
    cols = waveform_frame(x, inner_w) if n else np.zeros((inner_w, 2), np.float32)
    scale = max(peak, 1e-6)
    mid = y0 + wf_h // 2
    img[mid, pad : pad + inner_w] = (40, 44, 56)
    for c in range(inner_w):
        lo = int(mid - cols[c, 1] / scale * (wf_h // 2 - 2))
        hi = int(mid - cols[c, 0] / scale * (wf_h // 2 - 2))
        img[min(lo, hi) : max(lo, hi) + 1, pad + c] = (94, 201, 255)

    # spectrogram: one 512-pt spectrum per block, resampled to width
    y0 += wf_h + gap
    _panel(img, pad - 1, y0 - 1, inner_w + 2, sg_h + 2, "SPECTROGRAM 0-NYQUIST")
    block = 1024
    n_blocks = max(1, n // block)
    specs = np.zeros((n_blocks, 256), np.float32)
    for i in range(n_blocks):
        specs[i] = spectrum_frame(x[i * block : (i + 1) * block])
    smax = max(float(specs.max()), 1e-6)
    ci = np.minimum((np.arange(inner_w) * n_blocks) // inner_w, n_blocks - 1)
    ri = np.minimum((np.arange(sg_h) * 256) // sg_h, 255)
    grid = specs[np.ix_(ci, ri)].T / smax  # [sg_h, inner_w], row 0 = low freq
    img[y0 : y0 + sg_h, pad : pad + inner_w] = _spectrogram_color(grid[::-1])

    # loudest block for the detail panels
    bi = int(np.argmax([np.abs(x[i * block : (i + 1) * block]).max()
                        for i in range(n_blocks)])) if n else 0
    hot = x[bi * block : (bi + 1) * block]
    t_hot = bi * block / sample_rate

    # spectrum area chart (DrawSpectrum)
    y0 += sg_h + gap
    _panel(img, pad - 1, y0 - 1, inner_w + 2, sp_h + 2,
           f"SPECTRUM AT {t_hot:.2f}S")
    spec = spectrum_frame(hot)
    spmax = max(float(spec.max()), 1e-6)
    si = np.minimum((np.arange(inner_w) * 256) // inner_w, 255)
    heights = (spec[si] / spmax * (sp_h - 4)).astype(int)
    for c in range(inner_w):
        if heights[c] > 0:
            img[y0 + sp_h - 2 - heights[c] : y0 + sp_h - 2, pad + c] = (255, 170, 60)

    # synced oscilloscope (DrawOscilloscope)
    y0 += sp_h + gap
    dom_bin = int(np.argmax(spec[1:])) + 1 if len(spec) > 1 else 0
    sync = dom_bin * sample_rate / 512.0 if dom_bin > 0 else None
    _panel(img, pad - 1, y0 - 1, inner_w + 2, os_h + 2,
           f"OSCILLOSCOPE SYNC {0.0 if sync is None else sync:.0f}HZ")
    osc = oscilloscope_frame(hot, sync, sample_rate, inner_w)
    omax = max(float(np.abs(osc).max()), 1e-6)
    mid = y0 + os_h // 2
    img[mid, pad : pad + inner_w] = (40, 44, 56)
    prev = mid
    for c in range(inner_w):
        yy = int(mid - osc[c] / omax * (os_h // 2 - 2))
        img[min(prev, yy) : max(prev, yy) + 1, pad + c] = (140, 255, 140)
        prev = yy
    return img


def main(argv=None) -> int:
    """CLI: python -m zang_tpu_torch.host.visual render.wav out.png

    The offline analog of the reference's in-window visualizer — one
    command turns any render into an inspectable image."""
    import argparse
    import os

    from ..core.wav import read_wav_f32

    ap = argparse.ArgumentParser(
        prog="zang-visual",
        description="Render a WAV to an inspection PNG "
                    "(waveform + spectrogram + spectrum + oscilloscope)")
    ap.add_argument("wav")
    ap.add_argument("output", help="output image (.png)")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--channel", type=int, default=0,
                    help="channel to display (default 0)")
    args = ap.parse_args(argv)

    audio, sr = read_wav_f32(args.wav)
    ch = min(args.channel, audio.shape[0] - 1)
    img = render_image(audio[ch], sr, width=args.width,
                       title=os.path.basename(args.wav))
    write_png(args.output, img)
    print(f"{args.output}: {img.shape[1]}x{img.shape[0]} "
          f"from {audio.shape[1]} samples @ {sr}Hz")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
