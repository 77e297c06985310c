"""The port's delay lines, the stereo post chain and the poly_echo config
against zang_tpu's.

Delays are pure shifts and bit-exact. The echo's lowpass is the plain
affine-scan SVF in both packages, whose association orders differ, so the
echoes are held below -120 dBFS RMS and the end states within 1e-5 (the
SVF bounds of tests/test_ops_effects.py); the poly_echo render below
-110 dBFS RMS on both channels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zang_tpu.graph import render as jrender
from zang_tpu.host import configs as jconfigs
from zang_tpu.ops import delay as jdelay
from zang_tpu_torch import convert
from zang_tpu_torch.core.wav import read_wav
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.graph.fidelity import deviation_dbfs
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import instruments as tinstruments
from zang_tpu_torch.host import render_wav
from zang_tpu_torch.ops import delay as tdelay

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

POLY = dict(num_voices=4, seconds=3.0, main_delay=3000, seed=7)  # tests/test_configs.py
CHUNK = 16384


def _db(a, b):
    return deviation_dbfs(np.asarray(a), np.asarray(b))[0]


def test_simple_delay_bit_exact():
    rng = np.random.default_rng(0)
    state = rng.standard_normal((2, 700)).astype(np.float32)
    x = rng.standard_normal((2, 1500)).astype(np.float32)
    js, jo = jdelay.simple_delay(jnp.asarray(state), jnp.asarray(x))
    ts, to = tdelay.simple_delay(torch.from_numpy(state), torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("n, delay", [(65536, 15000), (16384, 3000), (4096, 4096),
                                      (1024, 5000), (48, 7)])
def test_sub_chunk(n, delay):
    assert tdelay._sub_chunk(n, delay) == jdelay._sub_chunk(n, delay)


def test_sub_chunk_raises_like_jax():
    for mod in (jdelay, tdelay):
        with pytest.raises(ValueError):
            mod._sub_chunk(21, 5)


def test_stereo_echoes_chained():
    """Two chunks of 8192 through stereo_echoes(main delay 3000): output,
    delay lines and echo filter state."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(2 * 8192) * 0.2).astype(np.float32)
    jst = jdelay.stereo_echoes_init(3000)
    tst = tdelay.stereo_echoes_init(3000, "cpu")
    for k in range(2):
        xs = x[k * 8192:(k + 1) * 8192]
        jst, jout = jdelay.stereo_echoes(jst, jnp.asarray(xs), 0.6, 0.7)
        tst, tout = tdelay.stereo_echoes(tst, torch.from_numpy(xs), 0.6, 0.7)
        assert tout.shape == (2, 8192)
        assert _db(tout.numpy(), jout) < -120.0
    for key in ("delay0", "delay1"):
        assert _db(tst[key].numpy(), jst[key]) < -120.0
    assert _db(tst["echo"]["buf"].numpy(), jst["echo"]["buf"]) < -120.0
    for key in ("l", "b"):
        assert abs(float(tst["echo"][key]) - float(jst["echo"][key])) < 1e-5
    assert np.abs(np.asarray(jout)).max() > 0.1


@pytest.fixture(scope="module")
def poly_pair():
    jperf, total = jconfigs.build_poly_echo_performance(**POLY)
    tperf, total2 = tconfigs.build_poly_echo_performance(**POLY)
    assert total2 == total
    return jperf, tperf, total


@pytest.fixture(scope="module")
def poly_jax(poly_pair):
    jperf, _, total = poly_pair
    return np.asarray(jrender.render_performance(jperf, total, chunk_size=CHUNK))


def test_poly_echo_matches_jax(poly_pair, poly_jax):
    """Both channels of the 4-voice render; measured -139.6 dBFS RMS."""
    _, tperf, total = poly_pair
    got = trender.render_performance(tperf, total, CHUNK, device="cpu")
    assert got.shape == (2, total) and got.dtype == torch.float32
    assert np.abs(poly_jax).max() > 0.1
    assert not np.array_equal(poly_jax[0], poly_jax[1])  # the echoes are mirrored
    for ch in range(2):
        assert _db(got[ch].numpy(), poly_jax[ch]) < -110.0


def test_poly_echo_grouped_matches_jax(poly_pair, poly_jax, monkeypatch):
    """The render by groups of voices (the path of 4096 voices and more),
    forced here to groups of 3 of the 4 voices: the ungrouped bits, so the
    same distance from the JAX render."""
    _, tperf, total = poly_pair
    want = trender.render_performance(tperf, total, CHUNK, device="cpu")
    monkeypatch.setattr(tinstruments, "GROUP_VOICE_SAMPLES", 3 * CHUNK)
    got = trender.render_performance(tperf, total, CHUNK, device="cpu")
    assert torch.equal(got, want)
    for ch in range(2):
        assert _db(got[ch].numpy(), poly_jax[ch]) < -110.0


def test_poly_echo_plans_match(poly_pair):
    """The port's own plans of the texture song equal the JAX package's."""
    jperf, tperf, _ = poly_pair
    (jp,), (tp,) = jperf.programs, tperf.programs
    np.testing.assert_array_equal(tp["active_from"], jp["active_from"])
    for name in ("phase", "env"):
        np.testing.assert_array_equal(tp[name].starts, jp[name].starts)
        for k, v in jp[name].values.items():
            np.testing.assert_array_equal(tp[name].values[k], v)


def test_poly_echo_state_across_calls(poly_pair):
    """The carried state: both packages step the first two chunks, their
    states agree, and the port resumes from the JAX package's state after
    chunk 1 (convert.from_jax_state, delay buffers and echo l/b
    included)."""
    jperf, _, total = poly_pair
    perf = convert.from_jax_performance(
        jperf, "cpu", post=tconfigs.poly_echo_post(POLY["num_voices"], POLY["main_delay"]))
    jxs, _ = jperf.chunk_xs(total, CHUNK)
    txs, _ = trender.host_slices(perf, total, CHUNK)
    jstep = jrender.make_stream_step(jperf, CHUNK)
    jstate = jperf.init_state()
    tstate = perf.init_state("cpu")
    static = [trender._map_arrays(p, lambda a: trender._to_device(a, "cpu"))
              for p in perf.programs]
    outs = []
    for i in range(2):
        jstate, jout = jstep(jstate, jnp.int32(i * CHUNK),
                             jax.tree_util.tree_map(lambda a, i=i: a[i], jxs))
        ctx = trender.RenderCtx(perf.sample_rate,
                                torch.arange(CHUNK, dtype=torch.int32) + i * CHUNK,
                                i * CHUNK, CHUNK)
        tstate, tout = perf.render_chunk(
            tstate, trender._map_arrays(txs, lambda a, i=i: trender._to_device(a[i], "cpu")),
            ctx, static)
        assert _db(tout.numpy(), jout) < -110.0
        outs.append(np.asarray(jout))
        if i == 0:  # resume the port from the JAX state
            tstate = convert.from_jax_state(jstate, "cpu")
    (jparts, jpost), (tparts, tpost) = jstate, tstate
    for key in ("l", "b"):
        np.testing.assert_allclose(tparts[0][key].numpy(), np.asarray(jparts[0][key]),
                                   rtol=0, atol=1e-5)
        assert abs(float(tpost["echo"][key]) - float(jpost["echo"][key])) < 1e-5
    for key in ("delay0", "delay1"):
        assert _db(tpost[key].numpy(), jpost[key]) < -110.0
    assert _db(tpost["echo"]["buf"].numpy(), jpost["echo"]["buf"]) < -110.0
    assert np.abs(outs[1]).max() > 0.1


def test_convert_needs_the_port_post_chain(poly_pair):
    with pytest.raises(ValueError, match="post_fn"):
        convert.from_jax_performance(poly_pair[0], "cpu")


def test_render_wav_poly_echo_cli(tmp_path, capsys):
    out = tmp_path / "poly.wav"
    render_wav.main(["poly_echo", str(out), "--seconds", "0.75", "--voices", "3",
                     "--device", "cpu"])
    wav = read_wav(str(out))
    assert (wav.sample_rate, wav.num_channels) == (44100, 2)
    pcm = np.frombuffer(wav.data, np.int16).reshape(-1, 2).T
    assert pcm.shape == (2, int(0.75 * 44100)) and np.count_nonzero(pcm) > 10000
    np.testing.assert_array_equal(
        pcm, tconfigs.render_config_s16("poly_echo", 0.75, voices=3, device="cpu"))
    assert "(2 ch)" in capsys.readouterr().out


def test_configs_golden_file():
    """zang_tpu_torch/data/configs_golden_jax.npz (tools/make_torch_golden.py):
    made at the render_wav defaults, with windows across chunk seams and at
    the end; the sampler's first window is the JAX render's, bit for bit."""
    import json
    import os

    from zang_tpu.host import configs as jc

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "zang_tpu_torch", "data", "configs_golden_jax.npz")
    assert os.path.getsize(path) <= 2 * 1024 * 1024
    g = np.load(path)
    p = json.loads(str(g["params"]))
    assert p["chunk_size"] == 65536 and p["window"] == 4096
    assert p["sampler"]["seconds"] == tconfigs.DEFAULT_SECONDS["sampler"]
    assert p["poly_echo"]["seconds"] == tconfigs.DEFAULT_SECONDS["poly_echo"]
    assert p["poly_echo"]["num_voices"] == 1024 and p["poly_echo"]["main_delay"] == 15000
    for name, channels in (("sampler", 1), ("poly_echo", 2)):
        total = int(p[name]["seconds"] * p[name]["sample_rate"])
        offs, win = g[f"{name}_offsets"], g[f"{name}_windows"]
        assert win.shape == (len(offs), channels, 4096) and win.dtype == np.float32
        assert offs[0] == 0 and offs[-1] + 4096 == total
        assert ((offs % 65536) > 65536 - 4096).sum() >= 3  # across chunk seams
        assert g[f"{name}_chunk_rms"].shape == (channels, -(-total // 65536))
        assert np.abs(win).max() > 0.05
    perf, _ = jc.build_sampler_performance(seconds=p["sampler"]["seconds"])
    first = np.asarray(jrender.render_performance(perf, 65536, chunk_size=65536))
    np.testing.assert_array_equal(g["sampler_windows"][0], first[:, :4096])


@pytest.mark.parametrize("voices", [4096, 16384])
def test_configs_golden_file_large_poly_echo(voices):
    """The capacity sizes of bench.py's bench_poly (8 s, StereoEchoes(15000)):
    rendered by JAX at a smaller chunk, recorded with the entry; windows
    across the 65536-frame seams of the port's render and at the end; the
    mix is scaled by 1 / voices, so its level is that of the 1024-voice
    entry."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "zang_tpu_torch", "data", "configs_golden_jax.npz")
    g = np.load(path)
    name = f"poly_echo_{voices}"
    p = json.loads(str(g["params"]))[name]
    assert (p["num_voices"], p["seconds"], p["main_delay"], p["seed"]) == (
        voices, 8.0, 15000, 0)
    assert p["jax_chunk"] % 512 == 0 and p["jax_chunk"] <= 65536
    total = int(p["seconds"] * p["sample_rate"])
    offs, win = g[f"{name}_offsets"], g[f"{name}_windows"]
    assert win.shape == (len(offs), 2, 4096) and win.dtype == np.float32
    assert offs[0] == 0 and offs[-1] + 4096 == total
    assert ((offs % 65536) > 65536 - 4096).sum() >= 3
    rms = g[f"{name}_chunk_rms"]
    assert rms.shape == (2, -(-total // 65536)) and np.abs(win).max() > 0.05
    assert not np.array_equal(win[:, 0], win[:, 1])
    assert np.abs(rms[:, 2:5] / g["poly_echo_chunk_rms"][:, 2:5] - 1.0).max() < 0.5


class _Stub:
    """A part that renders fixed audio: [V, n] voices, or [C, n] pre-mixed
    when output_channels is set."""

    def __init__(self, audio, xp, output_channels=None):
        self.audio, self.xp = audio, xp
        if output_channels is not None:
            self.output_channels = output_channels

    def plan(self, timelines, sample_rate):
        return {}

    def init_state(self, num_voices, device=None):
        return ()

    def render(self, state, prog, ctx):
        return state, self.xp(self.audio)


@pytest.mark.parametrize("post", [False, True], ids=["centre", "post_fn"])
def test_render_chunk_output_channels(post):
    """Instruments with output_channels add [C, n] after the post chain;
    mono parts go to every channel (or through post_fn), as in the JAX
    package's render_chunk."""
    rng = np.random.default_rng(4)
    voices = rng.standard_normal((3, 512)).astype(np.float32)
    stereo = rng.standard_normal((2, 512)).astype(np.float32)

    def jpost(state, mix, ctx):
        return state, jnp.stack([mix, -mix])

    def tpost(state, mix, ctx):
        return state, torch.stack([mix, -mix])

    outs = []
    for render_mod, xp, post_fn in ((jrender, jnp.asarray, jpost),
                                    (trender, torch.from_numpy, tpost)):
        parts = [(_Stub(voices, xp), [None] * 3), (_Stub(stereo, xp, 2), [None])]
        perf = render_mod.Performance(parts, 44100.0, num_channels=2,
                                      post_fn=post_fn if post else None)
        t_idx = np.arange(512, dtype=np.int32)
        if render_mod is jrender:
            ctx = jrender.RenderCtx(44100.0, jnp.asarray(t_idx), 512)
            state = perf.init_state()
        else:
            ctx = trender.RenderCtx(44100.0, torch.from_numpy(t_idx), 0, 512)
            state = perf.init_state("cpu")
        _, out = perf.render_chunk(state, [{}, {}], ctx)
        outs.append(np.asarray(out))
    np.testing.assert_array_equal(outs[1], outs[0])
    mix = voices.sum(axis=0)
    want = stereo + (np.stack([mix, -mix]) if post else mix[None, :])
    np.testing.assert_allclose(outs[1], want, rtol=0, atol=1e-6)
