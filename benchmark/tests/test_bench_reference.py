"""The frozen reference against the port's oracle, bit for bit at small
sizes, and the check that a run holds no module of a JAX package.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.entries import nice_voices, song
from benchmark.reference import renders as R

torch.set_num_threads(1)


def _song_ctx():
    cfg = harness.load_json("configs", "toccata")
    return song.setup(cfg, harness.load_json("traffic", "offline"))


def test_song_is_the_ports_oracle_bit_for_bit():
    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.host import song as ps

    ctx = _song_ctx()
    ref = R.song_oracle(song.job_song(ctx, {"transpose": 0}), 96000)
    port = mixdown_s16_np(ps.render_song_oracle(2.0)[None], 0.25)[0]
    assert np.abs(ref.astype(np.int32)).max() > 1000
    assert np.array_equal(ref, port)


def test_transposed_song_is_the_ports_oracle_on_the_same_score():
    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.core.notes import SongEvent
    from zang_tpu_torch.host import song as ps
    from zang_tpu_torch.oracle import engine as oe

    ctx = _song_ctx()
    plain = song.job_song(ctx, {"transpose": -7})
    port_song = [[SongEvent({"freq": float(f), "note_on": bool(on)}, t=float(t), note_id=int(n))
                  for t, n, f, on in zip(p["t"], p["note_id"], p["freq"], p["note_on"])]
                 for p in plain]
    voices = ps.build_oracle_voices("parity", song=port_song)

    def paint(span, outputs, temps):
        for v in voices:
            v.paint(span, ps.SAMPLE_RATE, outputs, temps)

    port = mixdown_s16_np(oe.render_blocks(paint, 60000, 1, 3), 0.25)[0]
    assert np.array_equal(R.song_oracle(plain, 60000), port)


@pytest.mark.parametrize("workers", [1, 2])
def test_texture_is_the_ports_twin(workers):
    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.host import configs as pc

    ref = R.texture_oracle(16, 2.0, 7, 30000, workers=workers)
    port = mixdown_s16_np(pc.render_poly_echo_oracle(16, 2.0, frames=30000, seed=7), 0.25)
    assert np.abs(ref.astype(np.int32)).max() > 1000
    if workers == 1:
        assert np.array_equal(ref, port)  # the twin's voice order
    else:  # partial sums added in worker order: rounding apart
        assert np.abs(ref.astype(np.int32) - port).max() <= 1


def _lane():
    cfg = harness.load_json("configs", "nice_voices")
    tr = dict(harness.load_json("traffic", "live_fleet"), block=1024)
    ctx = nice_voices.setup(cfg, tr)
    events = nice_voices.lane_events(ctx, np.random.default_rng(5), 1, 48000 * 3)[0]
    return ctx, events


def test_live_lane_is_the_ports_oracle_bit_for_bit():
    """The port's oracle voice stack, fed the same impulses, gives the
    frozen copy's bits."""
    from zang_tpu_torch.oracle import engine as oe
    from zang_tpu_torch.oracle import instruments as oi

    ctx, events = _lane()
    assert len(events) > 10
    frames = 48000 * 3
    ref = R.live_lane_oracle(events, frames)
    voice = oe.Voice([], 4, lambda: oi.NiceInstrument(0.3, mode="parity"),
                     lambda sr, p: {"sample_rate": sr, "freq": p["freq"],
                                    "note_on": p["note_on"]})
    voice.tracker = R.FrameTracker(events)

    def paint(span, outputs, temps):
        voice.paint(span, 48000.0, outputs, temps[:2])

    port = oe.render_blocks(paint, frames, 1, 2)[0]
    assert np.abs(ref).max() > 0.01
    assert np.array_equal(ref, port)


def test_live_lane_matches_the_ports_live_session():
    """The events at their frames through a LiveSession on the CPU (the
    live host and the plain K2 path) against the lane reference."""
    from zang_tpu_torch.host import instruments as ti
    from zang_tpu_torch.host.live import LiveSession

    ctx, events = _lane()
    block = 1024
    s = LiveSession([(ti.NiceInstrument(0.3), 4)], 48000.0, block, device="cpu")
    n = 48000 * 3 // block
    out = []
    for k in range(n):
        for f, nid, freq, on in events:
            if f // block == k:
                s.push_event(0, {"freq": float(freq), "note_on": bool(on)}, note_id=int(nid),
                             impulse_frame=int(f % block))
        out.append(s.render_block()[0])
    got = np.concatenate(out)
    dev = R.deviation(got, R.live_lane_oracle(events, n * block))
    assert dev["rms_dbfs"] < -110, dev


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, -3.14159265, 0.0], np.float32)
    y = R.bf16(x)
    assert y.tolist()[:2] == [1.0, 1.0]  # a tie rounds to even
    assert y[2] == np.float32(1.0078125)
    assert abs(y[3] + 3.140625) < 1e-7 and y[4] == 0.0


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "zang_tpu", "zang_tpu.core",
         "zang_tpu_torch", "zang_tpu_torch.host.song", "jaxtyping", "numpy"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "zang_tpu", "zang_tpu.core"]


def _py(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_a_tiny_run_holds_no_jax_module():
    out = _py("import json; from benchmark.tests.tiny import run_tiny; "
              "from benchmark import harness; c, line, _ = run_tiny('toccata.offline', 0.5); "
              "print(json.dumps([c, harness.forbidden_modules()]))")
    correct, bad = json.loads(out)
    assert correct and bad == []


def test_a_module_named_jax_fails_the_check():
    out = _py("import sys, types, json; sys.modules['jax'] = types.ModuleType('jax'); "
              "from benchmark import harness; print(json.dumps(harness.forbidden_modules()))")
    assert json.loads(out) == ["jax"]


def test_the_reference_imports_nothing_of_the_port():
    out = _py("import sys, json; from benchmark.reference import renders as R; "
              "R.texture_oracle(4, 1.0, 3, 4000); "
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'zang_tpu_torch', 'zang_tpu', 'jax', 'torch'})))")
    assert json.loads(out) == []
