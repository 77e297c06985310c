"""The port's own host core (zang_tpu_torch/core) against zang_tpu.core.

The port keeps copies of the JAX package's JAX-free host modules and of
the C++ event and envelope compiler, built into zang_tpu_torch/build/.
Every comparison here is exact: timelines, envelope segments and WAV
bytes are host data that the renders of both packages start from.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zang_tpu.core import mixdown as jmix
from zang_tpu.core import native as jnative
from zang_tpu.core import notes as jnotes
from zang_tpu.core import span as jspan
from zang_tpu.core import trigger as jtrigger
from zang_tpu.core import timeline as jtl
from zang_tpu.core import wav as jwav
from zang_tpu.host import configs as jconfigs
from zang_tpu.host import song as jsong
from zang_tpu.ops import control as jctl
from zang_tpu_torch.core import mixdown as tmix
from zang_tpu_torch.core import native as tnative
from zang_tpu_torch.core import notes as tnotes
from zang_tpu_torch.core import span as tspan
from zang_tpu_torch.core import trigger as ttrigger
from zang_tpu_torch.core import timeline as ttl
from zang_tpu_torch.core import wav as twav
from zang_tpu_torch.core.notes import SongEvent
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import instruments as tinst
from zang_tpu_torch.host import song as tsong
from zang_tpu_torch.ops import _build
from zang_tpu_torch.ops import control as tctl

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "zang_tpu_torch")


def _assert_timelines_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.starts, r.starts)
        np.testing.assert_array_equal(g.resets, r.resets)
        assert g.params == r.params and g.total == r.total


@pytest.fixture(scope="module")
def songs():
    return jsong.load_song(), tsong.load_song()


def test_song_events_match(songs):
    jsongs, tsongs = songs
    for js, ts in zip(jsongs, tsongs):
        assert [(e.params, e.t, e.note_id) for e in ts] == \
               [(e.params, e.t, e.note_id) for e in js]


@pytest.mark.parametrize("part", [0, 1, 2])
def test_song_timelines_native(songs, part):
    """The whole 385 s song, each part, through the native compiler."""
    jsongs, tsongs = songs
    total = int(jsong.NUM_SECONDS * jsong.SAMPLE_RATE)
    ref = jtl.compile_timelines(jsongs[part], jsong.POLYPHONY[part], jsong.SAMPLE_RATE,
                                total)
    got = ttl.compile_timelines(tsongs[part], tsong.POLYPHONY[part], tsong.SAMPLE_RATE,
                                total)
    _assert_timelines_equal(got, ref)


def test_timelines_unordered_events_raise_like_jax():
    ev = [SongEvent({"note_on": True}, t=1.0, note_id=1),
          SongEvent({"note_on": True}, t=0.5, note_id=2)]
    for mod in (jtl, ttl):
        with pytest.raises(ValueError, match="chronological"):
            mod.compile_timelines(ev, 2, 44100.0, 88200)


def test_timelines_unhashable_params_raise():
    """The port has only the native compiler: params it cannot group raise
    instead of taking another path."""
    ev = [SongEvent({"note_on": True, "freq": [110.0]}, t=0.0, note_id=1)]
    with pytest.raises(TypeError):
        ttl.compile_timelines(ev, 1, 44100.0, 44100)


def test_texture_song_timelines():
    """make_texture_song at 16 voices, 5 s: events and timelines."""
    jsongs = jconfigs.make_texture_song(16, 5.0, seed=3)
    tsongs = tconfigs.make_texture_song(16, 5.0, seed=3)
    total = int(5.0 * 44100)
    for js, ts in zip(jsongs, tsongs):
        assert [(e.params, e.t, e.note_id) for e in ts] == \
               [(e.params, e.t, e.note_id) for e in js]
        _assert_timelines_equal(ttl.compile_timelines(ts, 1, 44100.0, total),
                                jtl.compile_timelines(js, 1, 44100.0, total))


def test_envelopes_native(songs):
    """The organ's envelope segments from the two native compilers."""
    total = 30 * 48000
    tls = jtl.compile_timelines(songs[0][1], 10, 48000.0, total)
    env = tinst.NiceInstrument(0.25)._env_const()
    params = lambda k, p: {**env, "note_on": bool(p["note_on"])}
    n_segs = 0
    for tl in tls:
        ref = jnative.compile_envelope_native(tl, 48000.0, params)
        got = tctl.compile_envelope(tl, 48000.0, params)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        n_segs += len(ref["start"])
    assert n_segs > 100
    # and the packed painter program, the device's input
    jp = jctl.painter_program([jnative.compile_envelope_native(tl, 48000.0, params)
                               for tl in tls], total)
    tp = tctl.painter_program([tctl.compile_envelope(tl, 48000.0, params)
                               for tl in tls], total)
    np.testing.assert_array_equal(tp.starts, jp.starts)
    for k in jp.values:
        np.testing.assert_array_equal(tp.values[k], jp.values[k])


def _note_walk(notes, span, trigger, song, polyphony, total, block=1024):
    """The Python note walk of one part, a mix block of `block` frames at a
    time (the script backend's and the live session's): NoteTracker ->
    PolyphonyDispatcher -> a Trigger a voice. Returns every impulse and
    every note span, as plain tuples."""
    tracker = notes.NoteTracker(song)
    dispatcher = notes.PolyphonyDispatcher(polyphony)
    triggers = [trigger.Trigger() for _ in range(polyphony)]
    out = []
    for b0 in range(0, total, block):
        sp = span.Span(0, min(block, total - b0))
        iap = tracker.consume(48000.0, sp)
        out.append(("block", b0, len(sp), float(tracker.t),
                    [(i.frame, i.note_id, i.event_id) for i in iap.impulses]))
        for v, (trig, viap) in enumerate(zip(triggers, dispatcher.dispatch(iap))):
            for r in trig.iterate(sp, viap):
                out.append((v, r.span.start, r.span.end, r.note_id_changed,
                            sorted(r.params.items())))
    return out


@pytest.mark.parametrize("part", [0, 1, 2])
def test_python_note_walk_matches(songs, part):
    """Span, NoteTracker, PolyphonyDispatcher and Trigger over the whole
    385 s song, each part walked in 1,024-frame blocks: identical outputs."""
    jsongs, tsongs = songs
    total = int(tsong.NUM_SECONDS * tsong.SAMPLE_RATE)
    poly = tsong.POLYPHONY[part]
    got = _note_walk(tnotes, tspan, ttrigger, tsongs[part], poly, total)
    want = _note_walk(jnotes, jspan, jtrigger, jsongs[part], poly, total)
    assert len(got) > total // 1024 and got == want


def test_note_core_queue_and_ids():
    """ImpulseQueue's capacity and order rules, IdGenerator and Span's
    check, in both packages."""
    res = []
    for notes, span in ((jnotes, jspan), (tnotes, tspan)):
        q, ids = notes.ImpulseQueue(), notes.IdGenerator()
        for f in (5, 3, 9, 9, *range(10, 50)):  # 3 is out of order; past 32 dropped
            q.push(f, ids.next(), {"note_on": True, "f": f})
        iap = q.consume()
        res.append(([(i.frame, i.note_id, i.event_id) for i in iap.impulses],
                    iap.paramses, len(q.consume()), len(span.Span(3, 10))))
        with pytest.raises(ValueError):
            span.Span(4, 3)
    assert res[0] == res[1] and len(res[0][0]) == notes.QUEUE_CAPACITY


@pytest.mark.parametrize("vol", [0.25, 1.0])
def test_mixdown_s8_equal(vol):
    rng = np.random.default_rng(11)
    mix = (rng.standard_normal(5000) * 2.5).astype(np.float32)
    mix[:8] = [np.nan, np.inf, -np.inf, 4.0, -4.0, 0.99999, -0.99999, -0.0]
    ref = jmix.mixdown_s8_np(mix, vol)
    np.testing.assert_array_equal(tmix.mixdown_s8_np(mix, vol), ref)
    got = tmix.mixdown_s8(torch.from_numpy(mix), vol)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0] == 0 and ref[1] == 126 and ref[2] == -127


def test_native_builds_into_the_port(tmp_path, monkeypatch):
    """The host compiler builds from the port's source into its build
    directory, keyed by a hash of source and flags."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.SRC == os.path.join(PORT, "csrc", "zang_host.cpp")
    assert tnative.build() > 0.0
    built = os.listdir(tmp_path)
    assert len(built) == 1 and built[0].startswith("libzang_host_")
    assert "-ffp-contract=off" in tnative.GXX_FLAGS
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.build() == 0.0  # cached by hash


def test_threads_build_a_stem_once(tmp_path, monkeypatch):
    """8 threads ask for one small C++ library at once through build_shared
    with g++: the compiler runs once, every thread gets the one .so and
    loads it, and no temp file is left behind."""
    import ctypes
    import shutil
    import threading

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int zt_probe(int x) { return 3 * x + 1; }\n')
    runs = []

    def gxx():
        runs.append(threading.get_ident())
        return shutil.which("g++")

    barrier = threading.Barrier(8, timeout=60)
    got, errors = [], []

    def build():
        try:
            barrier.wait()
            so = _build.build_shared(str(src), gxx, ["-O1", "-shared", "-fPIC"], "probe")
            got.append((so, ctypes.CDLL(so).zt_probe(4)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(runs) == 1
    assert len(got) == 8 and len({so for so, _ in got}) == 1
    assert all(v == 13 for _, v in got)
    assert os.listdir(tmp_path / "build") == [os.path.basename(got[0][0])]


def test_native_source_is_the_reference_copy():
    """The port's event compiler is the reference's source, line for line;
    its envelope compiler, which walks a part's voices in one call and reads
    a fresh stage's crossing from a table, is its own (held bit for bit to
    the JAX package's walk by test_torch_plan.py and test_envelopes_native)."""
    mark = "// Envelope compiler: C++ twin"
    with open(os.path.join(ROOT, "zang_tpu", "core", "native", "zang_host.cpp")) as f:
        ref = f.read()
    with open(tnative.SRC) as f:
        got = f.read()
    assert mark in ref and mark in got
    assert got.split(mark)[0] == ref.split(mark)[0]
    assert "zt_compile_timelines" in got.split(mark)[0]


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    pcm = rng.integers(-32768, 32767, (channels, 5000)).astype(np.int16)
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    twav.write_wav_s16(str(a), pcm if channels > 1 else pcm[0], 44100, channels)
    jwav.write_wav_s16(str(b), pcm if channels > 1 else pcm[0], 44100, channels)
    assert a.read_bytes() == b.read_bytes()
    for read in (twav.read_wav, jwav.read_wav):
        w = read(str(a))
        assert (w.num_channels, w.sample_rate, w.bits_per_sample) == (channels, 44100, 16)
        got = np.frombuffer(w.data, np.int16).reshape(-1, channels).T
        np.testing.assert_array_equal(got, pcm)


def test_read_drumloop():
    ref = jwav.read_wav(jconfigs.DRUMLOOP)
    got = twav.read_wav(tconfigs.DRUMLOOP)
    assert tconfigs.DRUMLOOP == jconfigs.DRUMLOOP
    assert (got.num_channels, got.sample_rate, got.bits_per_sample, got.data) == \
           (ref.num_channels, ref.sample_rate, ref.bits_per_sample, ref.data)


def _port_sources():
    for dirpath, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "build"]  # build outputs, not sources
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_port_sources_import_no_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or
    zang_tpu (the data files under zang_tpu/data are read as data)."""
    bad = []
    for path in [*_port_sources(), os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import ", "from ")) and (
                        s.split()[1].split(".")[0] in ("jax", "zang_tpu", "jaxlib")):
                    bad.append(f"{path}:{i}: {s}")
    assert not bad, bad


def test_port_modules_load_no_jax_package():
    """Importing every module of the port, the reference oracle's copy
    (zang_tpu_torch.oracle) among them, leaves no jax and no zang_tpu
    module in sys.modules."""
    code = (
        "import pkgutil, sys, zang_tpu_torch\n"
        "for m in pkgutil.walk_packages(zang_tpu_torch.__path__, 'zang_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "from zang_tpu_torch.host.examples import ex_detuned, ex_stereo\n"
        "for ex in (ex_detuned, ex_stereo):  # the twins whose JAX twins use jax\n"
        "    assert ex(seconds=0.2, backend='oracle')[0].any()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zang_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'zang_tpu_torch.host.configs' in sys.modules\n"
        "assert 'zang_tpu_torch.script.torch_backend' in sys.modules\n"
        "assert 'zang_tpu_torch.serve.server' in sys.modules\n"
        "for m in ('serve.http', 'serve.batch', 'graph.checkpoint', 'host.visual',\n"
        "          'serve.client', 'parallel.mesh', 'oracle', 'oracle.native',\n"
        "          'oracle.modules', 'oracle.instruments', 'oracle.engine',\n"
        "          'oracle.examples', 'oracle.script'):\n"
        "    assert 'zang_tpu_torch.' + m in sys.modules, m\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ZANG_PLATFORM"] = "cpu"  # would make zang_tpu/__init__.py import jax
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
