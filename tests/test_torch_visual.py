"""The port's visualizer (zang_tpu_torch/host/visual.py) and the terminal
client's visual modes (zang_tpu_torch/serve/client.py) against zang_tpu's.

Both visualizers are plain numpy, so every frame is held bit for bit: the
radix-2 FFT, the spectrum, waveform and oscilloscope frames, Visuals'
block frames, render_image's array, the PNG bytes and the CLI's file. The
client's sparkline lines and F1-F5 panels are held line for line to the
JAX client's for the same blocks.
"""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zang_tpu.core.wav import write_wav_s16
from zang_tpu.host import visual as jvis
from zang_tpu.serve.client import TerminalPlayer as JPlayer
from zang_tpu_torch.host import visual as tvis
from zang_tpu_torch.serve.client import TerminalPlayer as TPlayer

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 48000.0


def _audio(n=6000, seed=0):
    """A chord with noise and a silent stretch, f32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 1210.0 * t)
         + 0.05 * rng.standard_normal(n))
    x[n // 3:n // 2] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("n", [2, 8, 512, 1024])
def test_fft_radix2_bit_for_bit(n):
    rng = np.random.default_rng(n)
    re, im = rng.standard_normal(n), rng.standard_normal(n)
    jr, ji, tr, ti = re.copy(), im.copy(), re.copy(), im.copy()
    jvis.fft_radix2(jr, ji)
    tvis.fft_radix2(tr, ti)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(ti, ji)


def test_frames_bit_for_bit():
    x = _audio()
    for log_scale in (True, False):
        np.testing.assert_array_equal(tvis.spectrum_frame(x, 512, log_scale),
                                      jvis.spectrum_frame(x, 512, log_scale))
    np.testing.assert_array_equal(tvis.spectrum_frame(x[:100]),
                                  jvis.spectrum_frame(x[:100]))  # zero-padded
    for width in (64, 512):
        np.testing.assert_array_equal(tvis.waveform_frame(x, width),
                                      jvis.waveform_frame(x, width))
    for sync in (None, 440.0, 20.0):
        np.testing.assert_array_equal(tvis.oscilloscope_frame(x, sync, SR),
                                      jvis.oscilloscope_frame(x, sync, SR))


def test_visuals_block_frames_bit_for_bit():
    x = _audio(4096 + 300)
    sync = np.where(np.arange(len(x)) < 2048, 440.0, 0.0).astype(np.float32)
    got = list(tvis.Visuals(SR).frames(x, sync))
    want = list(jvis.Visuals(SR).frames(x, sync))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["start"] == w["start"]
        for k in ("waveform", "spectrum", "oscilloscope"):
            np.testing.assert_array_equal(g[k], w[k])


def test_render_image_and_png_bit_for_bit(tmp_path):
    x = _audio(12000)
    got = tvis.render_image(x, SR, width=320, title="port")
    want = jvis.render_image(x, SR, width=320, title="port")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    a, b = tmp_path / "port.png", tmp_path / "jax.png"
    tvis.write_png(str(a), got)
    jvis.write_png(str(b), want)
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_draw_text_bit_for_bit():
    got = np.zeros((12, 200, 3), np.uint8)
    want = got.copy()
    tvis.draw_text(got, 2, 2, "Peak -3.1 dBFS 44100Hz %+/:?", (200, 10, 30))
    jvis.draw_text(want, 2, 2, "Peak -3.1 dBFS 44100Hz %+/:?", (200, 10, 30))
    np.testing.assert_array_equal(got, want)


def test_cli_writes_the_jax_clis_png(tmp_path, capsys):
    """python -m zang_tpu_torch.host.visual in.wav out.png: the same PNG."""
    pcm = (np.stack([_audio(9000, 1), _audio(9000, 2)]) * 20000).astype(np.int16)
    wav = tmp_path / "in.wav"
    write_wav_s16(str(wav), pcm, int(SR), num_channels=2)
    a, b = tmp_path / "port.png", tmp_path / "jax.png"
    assert tvis.main([str(wav), str(a), "--width", "256", "--channel", "1"]) == 0
    assert jvis.main([str(wav), str(b), "--width", "256", "--channel", "1"]) == 0
    assert a.read_bytes() == b.read_bytes()
    assert "256x" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the terminal client's visual modes


def _stub(cls, mode, specs=None, values=None):
    """A TerminalPlayer's visual state without a server (as
    tests/test_serve_client.py builds it)."""
    stub = SimpleNamespace(
        visual_mode=mode, quiet=True, _full_scale=32767.0, _panel_height=0,
        recording_file=None, level=0.5, blocks_received=7, param_specs=specs,
        param_values=values, param_sel=1 if specs else 0,
        client=SimpleNamespace(welcome={"sample_rate": SR}),
        _spark=cls._spark, _raster=cls._raster, _raster_bipolar=cls._raster_bipolar,
        _VISUAL_MODES=cls._VISUAL_MODES, _PANEL_MODES=cls._PANEL_MODES,
        PANEL_WIDTH=cls.PANEL_WIDTH, PANEL_ROWS=cls.PANEL_ROWS)
    stub.recorder = SimpleNamespace(state="recording")
    stub._sync_freq = lambda x, sr: cls._sync_freq(stub, x, sr)
    stub._status_line = lambda: cls._status_line(stub)
    stub._note = lambda *a, **k: None
    stub._ensure_params = lambda: False
    stub.render_panel = lambda b: cls.render_panel(stub, b)
    return stub


def _blocks():
    t = np.arange(4096, dtype=np.float32) / SR
    sine = (np.sin(2 * np.pi * 440.0 * t) * 32000).astype(np.int16)[None, :]
    noisy = (np.random.default_rng(5).standard_normal((2, 1024)) * 9000).astype(np.int16)
    return {"sine": sine, "noise": noisy, "silence": np.zeros((1, 1024), np.int16)}


SPECS = [{"name": "a", "desc": "alpha", "num_values": 10},
         {"name": "b", "desc": "beta", "num_values": 4}]


@pytest.mark.parametrize("mode", ["help", "main", "oscope", "fft", "params"])
def test_panels_are_the_jax_clients_lines(mode):
    for name, block in _blocks().items():
        got = TPlayer.render_panel(_stub(TPlayer, mode, SPECS, {"a": 3}), block)
        want = JPlayer.render_panel(_stub(JPlayer, mode, SPECS, {"a": 3}), block)
        assert got == want, (mode, name)
    assert TPlayer.render_panel(_stub(TPlayer, "params"), _blocks()["sine"]) == \
        JPlayer.render_panel(_stub(JPlayer, "params"), _blocks()["sine"])


def _printed(cls, method, mode, block):
    stub = _stub(cls, mode)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        getattr(cls, method)(stub, block)
    return err.getvalue()


@pytest.mark.parametrize("mode", ["wave", "spec", "scope"])
def test_sparklines_are_the_jax_clients(mode):
    for block in _blocks().values():
        assert _printed(TPlayer, "_print_visual", mode, block) == \
            _printed(JPlayer, "_print_visual", mode, block)


def test_print_panel_and_mode_cycle_as_the_jax_client():
    block = _blocks()["sine"]
    assert _printed(TPlayer, "_print_panel", "fft", block) == \
        _printed(JPlayer, "_print_panel", "fft", block)
    seen = {}
    for cls in (TPlayer, JPlayer):
        stub = _stub(cls, None)
        stub.set_visual = lambda m, stub=stub, cls=cls: cls.set_visual(stub, m)
        seen[cls] = []
        for _ in range(10):
            cls.cycle_visual(stub)
            seen[cls].append(stub.visual_mode)
        cls.set_visual(stub, "wave")  # a panel's own key toggles it off
        seen[cls].append(stub.visual_mode)
    assert seen[TPlayer] == seen[JPlayer]
    assert seen[TPlayer][:9] == ["wave", "spec", "scope", "help", "main", "oscope",
                                 "fft", "params", None]


def test_fkeys_map_to_the_jax_clients_panels():
    from zang_tpu.serve import client as jclient
    from zang_tpu_torch.serve import client as tclient

    assert tclient._FKEY_PANELS == jclient._FKEY_PANELS
