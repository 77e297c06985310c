"""The port's checkpointed renders (zang_tpu_torch/graph/checkpoint.py) and
convert.from_jax_checkpoint against zang_tpu's (tests/test_checkpoint_keyboard.py),
on the CPU.

- A render interrupted for real (the process of saving raises after the
  first checkpoint lands) and resumed in a fresh call is the uninterrupted
  render_performance, bit for bit; the resumed call renders only the chunks
  that are left. A completed checkpoint resumes to the same bits.
- The file is the JAX package's layout: a checkpoint the JAX package wrote
  mid-render loads into the port's state (from_jax_checkpoint: the leaves
  in the JAX pytree order, u32 counters as int64) and the port's resumed
  render is within -90 dBFS RMS of the JAX package's resumed render (the
  parity budget): the keyboard song of tests/test_checkpoint_keyboard.py
  (filter l/b) and the sampler chain (a u32 decimator counter).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from zang_tpu.core.timeline import compile_timelines as jcompile
from zang_tpu.graph import checkpoint as jckpt
from zang_tpu.graph.render import Performance as JPerformance
from zang_tpu.host import configs as jconfigs
from zang_tpu.host import instruments as jti
from zang_tpu.host.keyboard import keys_to_song as jkeys_to_song
from zang_tpu_torch import convert
from zang_tpu_torch.core.timeline import compile_timelines as tcompile
from zang_tpu_torch.graph import checkpoint as tckpt
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import instruments as tti
from zang_tpu_torch.host.keyboard import keys_to_song as tkeys_to_song

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 44100.0
CHUNK = 8192
BUDGET_DB = -90.0
KEYS = [(0.05, "z", True), (0.4, "z", False), (0.5, "y", True), (0.9, "y", False)]


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


def _keyboard(total):
    """tests/test_checkpoint_keyboard.py's song, the port's Performance."""
    tls = tcompile(tkeys_to_song(KEYS), 2, SR, total)
    return trender.Performance([(tti.NiceInstrument(0.25), tls)], SR)


class _Interrupted(Exception):
    pass


def _interrupt_after_first_save(monkeypatch, module):
    """Make module.render_resumable stop for real once its first checkpoint
    is on disk."""
    real = module.save_checkpoint

    def save_then_stop(*a, **k):
        real(*a, **k)
        raise _Interrupted

    monkeypatch.setattr(module, "save_checkpoint", save_then_stop)


def test_resume_after_a_real_interruption_is_bit_exact(tmp_path, monkeypatch):
    total = int(1.5 * SR)  # 9 chunks; segments of 4: 4 + 4 + 1
    n_chunks = -(-total // CHUNK)
    base = trender.render_performance(_keyboard(total), total, CHUNK, device="cpu").numpy()
    ckpt = str(tmp_path / "render.npz")
    with monkeypatch.context() as m:
        _interrupt_after_first_save(m, tckpt)
        with pytest.raises(_Interrupted):
            tckpt.render_resumable(_keyboard(total), total, ckpt, CHUNK, segment_chunks=4,
                                   device="cpu")
    perf = _keyboard(total)
    chunk_index, state, audio = tckpt.load_checkpoint(ckpt, perf.init_state("cpu"))
    assert chunk_index == 4 and audio.shape == (1, 4 * CHUNK)
    np.testing.assert_array_equal(audio, base[:, :4 * CHUNK])

    steps = []
    real_step = trender.make_stream_step

    def counting(*a, **k):
        step = real_step(*a, **k)

        def wrapped(st, c0, xs):
            steps.append(c0 // CHUNK)
            return step(st, c0, xs)
        return wrapped

    monkeypatch.setattr(tckpt, "make_stream_step", counting)
    resumed = tckpt.render_resumable(perf, total, ckpt, CHUNK, segment_chunks=4,
                                     device="cpu")
    assert steps == list(range(4, n_chunks))  # only the chunks that were left
    assert resumed.dtype == np.float32
    np.testing.assert_array_equal(resumed, base)

    # the checkpoint now says complete: resuming renders nothing, same bits
    chunk_index, _, _ = tckpt.load_checkpoint(ckpt, perf.init_state("cpu"))
    assert chunk_index == n_chunks
    steps.clear()
    again = tckpt.render_resumable(_keyboard(total), total, ckpt, CHUNK, segment_chunks=4,
                                   device="cpu")
    assert steps == []
    np.testing.assert_array_equal(again, base)


def test_the_file_is_the_jax_layout(tmp_path):
    """chunk_index, audio and leaf_i in the JAX pytree order (dict entries
    by sorted key), which the JAX package's own load_checkpoint reads into
    its state of the same song."""
    total = int(0.6 * SR)
    perf = _keyboard(total)
    ckpt = str(tmp_path / "port.npz")
    tckpt.render_resumable(perf, total, ckpt, CHUNK, segment_chunks=2, device="cpu")
    z = np.load(ckpt)
    assert sorted(z.files) == ["audio", "chunk_index", "leaf_0", "leaf_1"]
    leaves = tckpt.state_leaves(perf.init_state("cpu"))  # NiceInstrument's b, l
    assert [tuple(x.shape) for x in leaves] == [z["leaf_0"].shape, z["leaf_1"].shape]
    jtls = jcompile(jkeys_to_song(KEYS), 2, SR, total)
    jperf = JPerformance([(jti.NiceInstrument(0.25), jtls)], SR)
    chunk_index, jstate, audio = jckpt.load_checkpoint(ckpt, jperf.init_state())
    assert chunk_index == -(-total // CHUNK)
    np.testing.assert_array_equal(np.asarray(jstate[0][0]["b"]), z["leaf_0"])
    np.testing.assert_array_equal(np.asarray(jstate[0][0]["l"]), z["leaf_1"])


def _jax_keyboard(total):
    jtls = jcompile(jkeys_to_song(KEYS), 2, SR, total)
    return JPerformance([(jti.NiceInstrument(0.25), jtls)], SR)


@pytest.mark.parametrize("piece", ["keyboard", "sampler"])
def test_a_jax_checkpoint_resumes_in_the_port(piece, tmp_path, monkeypatch):
    # 0.7 s: 4 chunks, two segments of 2 (one segment shape for the JAX jit)
    if piece == "keyboard":
        total = int(0.7 * SR)
        make_jax = lambda: _jax_keyboard(total)
    else:
        _, total = jconfigs.build_sampler_performance(seconds=0.7)
        make_jax = lambda: jconfigs.build_sampler_performance(seconds=0.7)[0]
    ckpt = str(tmp_path / "jax.npz")
    with monkeypatch.context() as m:
        _interrupt_after_first_save(m, jckpt)
        with pytest.raises(_Interrupted):
            jckpt.render_resumable(make_jax(), total, ckpt, CHUNK, segment_chunks=2)
    mid = str(tmp_path / "jax_mid.npz")
    shutil.copy(ckpt, mid)
    want = np.asarray(jckpt.render_resumable(make_jax(), total, ckpt, CHUNK,
                                             segment_chunks=2))

    tperf = convert.from_jax_performance(make_jax(), "cpu")
    chunk_index, state, audio = convert.from_jax_checkpoint(mid, tperf, "cpu")
    assert chunk_index == 2 and audio.shape[1] == 2 * CHUNK
    jleaves = np.load(mid)
    for i, leaf in enumerate(tckpt.state_leaves(state)):
        ref = jleaves[f"leaf_{i}"]
        if ref.dtype == np.uint32:
            assert leaf.dtype == torch.int64
        np.testing.assert_array_equal(leaf.numpy(), ref.astype(leaf.numpy().dtype))
    got = tckpt.render_resumable(tperf, total, mid, CHUNK, segment_chunks=2, device="cpu")
    assert got.shape == want.shape and np.abs(want).max() > 0.01
    np.testing.assert_array_equal(got[:, :2 * CHUNK], want[:, :2 * CHUNK])  # the file's
    for ch in range(want.shape[0]):
        db = _rms_db(got[ch], want[ch])
        print(f"{piece} resumed from the JAX checkpoint, channel {ch}: {db:.1f} dBFS")
        assert db < BUDGET_DB, db


def test_a_checkpoint_of_another_piece_is_refused(tmp_path):
    total = int(0.4 * SR)
    ckpt = str(tmp_path / "keys.npz")
    tckpt.render_resumable(_keyboard(total), total, ckpt, CHUNK, segment_chunks=2,
                           device="cpu")
    sampler, _ = tconfigs.build_sampler_performance(seconds=0.4)
    with pytest.raises(ValueError, match="state leaves|shape"):
        convert.from_jax_checkpoint(ckpt, sampler, "cpu")
    assert os.path.exists(ckpt)
