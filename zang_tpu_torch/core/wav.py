"""Minimal WAV (RIFF PCM) reader/writer.

The reference uses the external zig-wav package (not vendored in the
snapshot; build.zig:67-69). We implement the small subset zang needs:
- write: PCM unsigned8 / signed16_lsb, any channel count
- read: PCM u8 / i16 / i24 / i32 into the raw byte form the Sampler consumes
  (sample decode conventions live in ops/sampler.py and match
  src/modules/Sampler.zig:24-60).

A copy of zang_tpu/core/wav.py: the port keeps its own host core and imports
nothing of zang_tpu.
"""

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class WavData:
    num_channels: int
    sample_rate: int
    bits_per_sample: int  # 8, 16, 24, or 32 (integer PCM)
    data: bytes  # raw interleaved PCM frames


def write_wav_s16(path: str, samples: np.ndarray, sample_rate: int, num_channels: int = 1) -> None:
    """samples: int16 array, interleaved if multichannel ([n*ch] or [ch, n])."""
    if samples.ndim == 2:
        samples = np.ascontiguousarray(samples.T).reshape(-1)
    assert samples.dtype == np.int16
    _write(path, samples.tobytes(), sample_rate, num_channels, 16)


def write_wav_u8(path: str, samples: np.ndarray, sample_rate: int, num_channels: int = 1) -> None:
    """samples: int8 array (signed, as produced by mixdown); stored unsigned."""
    if samples.ndim == 2:
        samples = np.ascontiguousarray(samples.T).reshape(-1)
    u8 = (samples.astype(np.int16) + 128).astype(np.uint8)
    _write(path, u8.tobytes(), sample_rate, num_channels, 8)


def encode_wav_s16(samples: np.ndarray, sample_rate: int,
                   num_channels: int = 1) -> bytes:
    """In-memory WAV file bytes (int16 PCM; [n], [n*ch] interleaved, or
    [ch, n]) — the HTTP render tier streams these without touching disk."""
    if samples.ndim == 2:
        samples = np.ascontiguousarray(samples.T).reshape(-1)
    assert samples.dtype == np.int16
    return _encode(samples.tobytes(), sample_rate, num_channels, 16)


def wav_header_s16(sample_rate: int, num_channels: int,
                   total_frames: int) -> bytes:
    """The 44-byte RIFF header for an int16 WAV whose data will follow
    incrementally (streamed responses: length known, bytes not yet
    rendered)."""
    data_len = total_frames * num_channels * 2
    full = _encode(b"", sample_rate, num_channels, 16)
    head = bytearray(full)
    struct.pack_into("<I", head, 4, 36 + data_len)
    struct.pack_into("<I", head, 40, data_len)
    return bytes(head)


def _encode(data: bytes, sample_rate: int, num_channels: int, bits: int) -> bytes:
    byte_rate = sample_rate * num_channels * bits // 8
    block_align = num_channels * bits // 8
    return b"".join([
        b"RIFF",
        struct.pack("<I", 36 + len(data)),
        b"WAVE",
        b"fmt ",
        struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate,
                    block_align, bits),
        b"data",
        struct.pack("<I", len(data)),
        data,
    ])


def _write(path: str, data: bytes, sample_rate: int, num_channels: int, bits: int) -> None:
    with open(path, "wb") as f:
        f.write(_encode(data, sample_rate, num_channels, bits))


class StreamingWavWriter:
    """Incremental WAV writer: append PCM as it is rendered, then patch the
    RIFF/data sizes on close — the reference's write_wav flow (it writes
    blocks as they render and calls wav.patchHeader at the end,
    examples/write_wav.zig:86,95). Lets the batch server stream very long
    renders to disk segment by segment."""

    def __init__(self, path: str, sample_rate: int, num_channels: int = 1,
                 bits: int = 16) -> None:
        assert bits in (8, 16)
        self.path = path
        self.num_channels = num_channels
        self.bits = bits
        self._n_bytes = 0
        byte_rate = sample_rate * num_channels * bits // 8
        block_align = num_channels * bits // 8
        self._f = open(path, "wb")
        self._f.write(b"RIFF")
        self._f.write(struct.pack("<I", 36))  # patched on close
        self._f.write(b"WAVE")
        self._f.write(b"fmt ")
        self._f.write(struct.pack(
            "<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate,
            block_align, bits))
        self._f.write(b"data")
        self._f.write(struct.pack("<I", 0))  # patched on close

    def append(self, samples: np.ndarray) -> None:
        """samples: int16 (bits=16) or int8 (bits=8), [n*ch] or [ch, n]."""
        if samples.ndim == 2:
            samples = np.ascontiguousarray(samples.T).reshape(-1)
        if self.bits == 16:
            assert samples.dtype == np.int16
            data = samples.tobytes()
        else:
            data = (samples.astype(np.int16) + 128).astype(np.uint8).tobytes()
        self._f.write(data)
        self._n_bytes += len(data)

    def close(self) -> None:
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + self._n_bytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", self._n_bytes))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_wav(path: str) -> WavData:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            data = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, num_channels, sample_rate, _byte_rate, _block_align, bits = fmt
    if audio_format != 1:
        raise ValueError(f"{path}: only PCM supported (got format {audio_format})")
    return WavData(
        num_channels=num_channels,
        sample_rate=sample_rate,
        bits_per_sample=bits,
        data=data,
    )


def read_wav_f32(path: str) -> tuple:
    """Read a WAV and decode to float32 [-1, 1), shape [ch, n]. Returns (audio, sr)."""
    w = read_wav(path)
    if w.bits_per_sample == 8:
        arr = (np.frombuffer(w.data, dtype=np.uint8).astype(np.float32) - 127.5) / 127.5
    elif w.bits_per_sample == 16:
        arr = np.frombuffer(w.data, dtype="<i2").astype(np.float32) / 32768.0
    elif w.bits_per_sample == 24:
        b = np.frombuffer(w.data, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        arr = vals.astype(np.float32) / float(1 << 23)
    elif w.bits_per_sample == 32:
        arr = np.frombuffer(w.data, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported bits_per_sample {w.bits_per_sample}")
    n = arr.shape[0] // w.num_channels
    return arr[: n * w.num_channels].reshape(n, w.num_channels).T, w.sample_rate
