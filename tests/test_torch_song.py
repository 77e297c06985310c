"""The port's main path — the Bach Toccata render — against zang_tpu's.

The hard bound is the parity budget, -90 dBFS RMS (FIDELITY.md). Each
comparison asserts the value measured on the CPU when the test was written
plus a 10 dB margin, so a drift shows long before the budget is spent; the
s16 mixdowns differ by at most 1 LSB.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zang_tpu.core.notes import SongEvent
from zang_tpu.core.timeline import compile_timelines
from zang_tpu.core.wav import read_wav
from zang_tpu.graph import render as jrender
from zang_tpu.host import instruments as jinst
from zang_tpu.host import song as jsong
from zang_tpu_torch import convert
from zang_tpu_torch.core.mixdown import mixdown_s16_np
from zang_tpu_torch.device import require_device
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.graph.fidelity import deviation_dbfs
from zang_tpu_torch.host import render_wav
from zang_tpu_torch.host import song as tsong

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "zang_tpu_torch", "data", "song_golden_jax.npz")
SECONDS = 3.0
TOTAL = int(SECONDS * 48000)


@pytest.fixture(scope="module")
def jax_song():
    return jsong.render_song(SECONDS, chunk_size=65536)


def _assert_parity(got, ref, measured_db):
    rms_db, _ = deviation_dbfs(got, ref)
    assert rms_db < -90.0  # the parity budget
    assert rms_db < measured_db + 10.0, rms_db
    s16 = mixdown_s16_np(got, 0.25).astype(np.int32)
    s16_ref = mixdown_s16_np(ref, 0.25).astype(np.int32)
    assert np.abs(s16 - s16_ref).max() <= 1


def test_song_own_plans(jax_song):
    """render_song on the port's own plans; measured -141.7 dBFS."""
    got = tsong.render_song(SECONDS, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (TOTAL,)
    _assert_parity(got.numpy(), jax_song, -141.7)


def test_song_through_jax_programs(jax_song):
    """The JAX package's own programs and state, carried across with
    convert; measured -141.7 dBFS."""
    jperf = jsong.build_performance(TOTAL)
    perf = convert.from_jax_performance(jperf, "cpu")
    state = convert.from_jax_state(jperf.init_state(), "cpu")
    own = perf.init_state("cpu")
    torch.testing.assert_close(state, own, rtol=0, atol=0)
    assert state[1] == () and set(state[0][1]) == {"l", "b"}  # no post chain
    got = trender.render_performance(perf, TOTAL, 65536, device="cpu", state=state)
    _assert_parity(got[0].numpy(), jax_song, -141.7)


def test_golden_first_window_regenerates(jax_song):
    """zang_tpu_torch/data/song_golden_jax.npz (tools/make_torch_golden.py):
    its first window, at frame 0, is the JAX render's, bit for bit."""
    assert os.path.getsize(GOLDEN) <= 2 * 1024 * 1024
    g = np.load(GOLDEN)
    total, chunk, w = int(g["total"]), int(g["chunk_size"]), int(g["window"])
    offs = g["offsets"]
    assert total == int(jsong.NUM_SECONDS * jsong.SAMPLE_RATE) and chunk == 65536
    assert len(offs) >= 32 and g["windows"].shape == (len(offs), w) and w == 8192
    assert offs[0] == 0 and offs[-1] + w == total  # the final, partial chunk
    assert ((offs % chunk) > chunk - w).sum() >= 8  # windows across chunk seams
    assert g["chunk_rms"].shape == (-(-total // chunk),)
    np.testing.assert_array_equal(g["windows"][0], jax_song[:w])
    rms0 = np.sqrt(np.mean(jax_song[:chunk].astype(np.float64) ** 2))
    assert rms0 == g["chunk_rms"][0] and rms0 > 0.01


def _small_song():
    """Both instruments sounding within a few chunks: the song's first 3 s
    leave the pedal silent (its first note is at 9.75 s)."""
    rng = np.random.default_rng(11)

    def part(n_notes, lo, hi, start_id):
        evs = []
        t = 0.02
        for k in range(n_notes):
            f = float(rng.uniform(lo, hi))
            evs.append(SongEvent({"freq": f, "note_on": True}, t=t, note_id=start_id + k))
            t += float(rng.uniform(0.03, 0.12))
            evs.append(SongEvent({"freq": f, "note_on": False}, t=t, note_id=start_id + k))
            t += float(rng.uniform(0.0, 0.05))
        return evs

    return [part(6, 40.0, 120.0, 1), part(12, 200.0, 2000.0, 100)]


def test_instruments_match_jax_small():
    """PMOscInstrument and NiceInstrument at chunk 8192 (16 tiles), both
    audible; measured -141.3 dBFS."""
    total, chunk = 3 * 8192, 8192
    song = _small_song()
    tls = [compile_timelines(song[0], 2, 48000.0, total),
           compile_timelines(song[1], 3, 48000.0, total)]
    colors = np.array([0.25, 0.25, 0.1], np.float32)
    jperf = jrender.Performance(
        [(jinst.PMOscInstrument(0.4, freq_fn=jsong.pedal_freq), tls[0]),
         (jinst.NiceInstrument(colors), tls[1])], 48000.0)
    ref = jrender.render_performance(jperf, total, chunk_size=chunk)[0]
    tperf = trender.Performance(
        [(tsong.ti.PMOscInstrument(0.4, freq_fn=tsong.pedal_freq), tls[0]),
         (tsong.ti.NiceInstrument(colors), tls[1])], 48000.0)
    got = trender.render_performance(tperf, total, chunk, device="cpu")[0].numpy()
    assert np.abs(ref).max() > 0.1
    # the pedal alone is audible too
    pedal = trender.Performance(tperf.parts[:1], 48000.0)
    assert trender.render_performance(pedal, total, chunk, device="cpu").abs().max() > 0.1
    _assert_parity(got, ref, -141.3)


def test_render_wav_cli(tmp_path, capsys):
    out = tmp_path / "song.wav"
    render_wav.main(["song", str(out), "--seconds", "0.5", "--device", "cpu"])
    wav = read_wav(str(out))
    assert wav.sample_rate == 48000 and wav.num_channels == 1
    pcm = np.frombuffer(wav.data, np.int16)
    assert pcm.size == 24000 and np.count_nonzero(pcm) > 10000
    np.testing.assert_array_equal(pcm, tsong.render_song_s16(0.5, device="cpu"))
    assert "rendered 0.5s" in capsys.readouterr().out


def test_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        require_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tsong.render_song(0.1, device="cuda")
    with pytest.raises(ValueError):
        require_device("meta")


def test_port_imports_no_jax():
    code = ("import sys, zang_tpu_torch.host.song, zang_tpu_torch.graph.render, "
            "zang_tpu_torch.ops.filters, zang_tpu_torch.ops.svf_cuda, "
            "zang_tpu_torch.host.render_wav; assert 'jax' not in sys.modules, "
            "sorted(m for m in sys.modules if m.startswith('jax'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
