"""Streaming renders in the port (zang_tpu_torch/graph/render.py
make_stream_step, stream_blocks, stream_performance), on the CPU.

- stream_blocks' blocks, concatenated, are render_performance's output bit
  for bit (the same step), in the tiled and the flat chunk formats, with
  a post chain and state carried across chunks; every block is f32 numpy
  [C, <= chunk], the last one partial.
- One make_stream_step serves two streams of the same performance, and
  either stream gives the same bits.
- The blocks equal the JAX package's stream_performance within -90 dBFS
  (the parity budget).
- Without CUDA, asking for the card raises, before any block is rendered.
"""

import numpy as np
import pytest
import torch

from zang_tpu.graph import render as jrender
from zang_tpu.host import configs as jconfigs
from zang_tpu.host import song as jsong
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import song as tsong

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

BUDGET_DB = -90.0


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


@pytest.fixture(scope="module")
def song_perf():
    total = 2 * 48000 + 123
    return tsong.build_performance(total), total


@pytest.mark.parametrize("chunk", [8192, 7000], ids=["tiled", "flat"])
def test_stream_blocks_are_the_render(song_perf, chunk):
    perf, total = song_perf
    step = trender.make_stream_step(perf, chunk, device="cpu")
    blocks = list(trender.stream_blocks(perf, total, step, chunk))
    assert len(blocks) == -(-total // chunk)
    for i, b in enumerate(blocks):
        assert isinstance(b, np.ndarray) and b.dtype == np.float32
        assert b.shape == (1, min(chunk, total - i * chunk))
    got = np.concatenate(blocks, axis=1)
    want = trender.render_performance(perf, total, chunk, device="cpu").numpy()
    assert np.array_equal(got, want)
    assert np.abs(want).max() > 0.1


def test_one_step_serves_two_streams(song_perf):
    perf, total = song_perf
    step = trender.make_stream_step(perf, 8192, device="cpu")
    first = np.concatenate(list(trender.stream_blocks(perf, total, step, 8192)), axis=1)
    second = np.concatenate(list(trender.stream_blocks(perf, total, step, 8192)), axis=1)
    assert np.array_equal(first, second)
    # two streams interleaved block by block: the state is the stream's own
    a = trender.stream_blocks(perf, total, step, 8192)
    b = trender.stream_blocks(perf, total, step, 8192)
    inter = [(next(a), next(b)) for _ in range(3)]
    for i, (x, y) in enumerate(inter):
        assert np.array_equal(x, y)
        assert np.array_equal(x, first[:, i * 8192:(i + 1) * 8192])


def test_stream_with_a_post_chain():
    """poly_echo (16 voices, stereo echoes: a delay line carried across
    chunks) streamed at a flat chunk."""
    perf, total = tconfigs.build_poly_echo_performance(num_voices=16, seconds=1.0)
    blocks = list(trender.stream_performance(perf, total, 10000, device="cpu"))
    got = np.concatenate(blocks, axis=1)
    want = trender.render_performance(perf, total, 10000, device="cpu").numpy()
    assert got.shape == (2, total) and np.array_equal(got, want)
    jperf, _ = jconfigs.build_poly_echo_performance(num_voices=16, seconds=1.0)
    ref = np.concatenate(list(jrender.stream_performance(jperf, total, 10000)), axis=1)
    for ch in range(2):
        assert _rms_db(got[ch], ref[ch]) < BUDGET_DB


def test_stream_matches_jax_stream():
    total = 48000
    ref = np.concatenate(list(jrender.stream_performance(jsong.build_performance(total),
                                                         total, 16384)), axis=1)
    got = np.concatenate(list(trender.stream_performance(tsong.build_performance(total),
                                                         total, 16384, device="cpu")),
                         axis=1)
    assert got.shape == ref.shape
    db = _rms_db(got, ref)
    print(f"song stream vs JAX stream: {db:.1f} dBFS")
    assert db < BUDGET_DB


def test_asking_for_the_card_without_one_raises(song_perf, monkeypatch):
    perf, total = song_perf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: trender.make_stream_step(perf, 8192, device="cuda"),
                 lambda: trender.stream_performance(perf, total, 8192, device="cuda"),
                 lambda: trender.render_performance(perf, total, 8192, device="cuda")):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
