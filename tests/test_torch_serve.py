"""The port's serving tier on the CPU: LiveFleet (zang_tpu_torch/serve/live.py)
and the TCP server and client (serve/server.py, serve/client.py), plus the
live path of host/midi.py, against independent port sessions and the JAX
package's fleet.

- Fleet lanes equal independent port sessions fed the same events within
  TOL_LANES (1e-6, tests/test_serve_live.py:58-60's bound); a parameter
  set on one lane leaves another lane's bits alone; the dense-cut SVF's
  plain router is called once a part and block whatever the lane count;
  an FMSynth fleet with a waveform a lane is within TOL_DB (-110 dBFS) of
  the JAX fleet.
- Over localhost TCP (port 0; every wait polls against a deadline, every
  blocking read has its own timeout): the welcome frame, events and keys,
  blocks, stats, live parameters, resume tokens, snapshot/restore,
  MultiInstrumentServer routing and replay_live.
- The copies (host/keyboard.py, params.py, interaction.py) are the JAX
  package's modules, line for line.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

from zang_tpu.host import instruments as ji
from zang_tpu.serve.live import LiveFleet as JLiveFleet
from zang_tpu_torch.core.mixdown import mixdown_s16_np
from zang_tpu_torch.host import instruments as ti
from zang_tpu_torch.host import midi
from zang_tpu_torch.host.live import LiveSession
from zang_tpu_torch.ops import filters
from zang_tpu_torch.serve.live import LiveFleet
from zang_tpu_torch.serve.server import (
    LiveClient,
    LiveServer,
    MultiInstrumentServer,
    builtin_instruments,
    list_instruments,
)

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 48000.0
BLOCK = 1024
TOL_LANES = 1e-6  # fleet lanes vs sessions (tests/test_serve_live.py:58-60)
TOL_DB = -110.0
DEADLINE = 60.0  # seconds any wait on the server may take
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = "zxcvbnmqwertyu"


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


def _key_stream(seed, blocks):
    rng = np.random.default_rng(seed)
    return [[(KEYS[rng.integers(0, len(KEYS))], bool(rng.integers(0, 2)))
             for _ in range(rng.integers(0, 3))] for _ in range(blocks)]


# -- the fleet ---------------------------------------------------------------------


@pytest.mark.parametrize("name, make", [
    ("nice", lambda: [(ti.NiceInstrument(0.3), 3)]),
    ("fmsynth", lambda: [(ti.FMSynthInstrument(), 2)]),
    ("mousepm", lambda: [(ti.MousePMInstrument(), 2)]),
    ("two parts", lambda: [(ti.PMOscInstrument(1.0), 1), (ti.FilteredSawtoothInstrument(), 2)]),
])
def test_fleet_lanes_equal_sessions(name, make):
    lanes, blocks = 3, 8
    fleet = LiveFleet(make, lanes, SR, block_size=BLOCK, device="cpu")
    singles = [LiveSession(make(), SR, BLOCK, device="cpu") for _ in range(lanes)]
    streams = [_key_stream(20 + lane, blocks) for lane in range(lanes)]
    outs, refs = [], [[] for _ in range(lanes)]
    for b in range(blocks):
        for lane, stream in enumerate(streams):
            part = b % len(singles[0].parts)
            for k, down in stream[b]:
                fleet.key_event(lane, part, k, down)
                singles[lane].key_event(part, k, down)
        if name == "mousepm" and b == 2:
            fleet.push_controller(1, 0, "x", 0.9)
            singles[1].push_controller(0, "x", 0.9)
        outs.append(fleet.render_block())
        for lane in range(lanes):
            refs[lane].append(singles[lane].render_block())
    got = np.concatenate(outs, axis=2)
    for lane in range(lanes):
        assert np.abs(got[lane] - np.concatenate(refs[lane], axis=1)).max() <= TOL_LANES
    assert np.abs(got).max() > 0.01


def test_fleet_script_lanes_equal_sessions():
    """A zangscript part renders a lane at a time (its noise keys and delay
    loop take host scalars a lane): still each lane's session's bits."""
    from zang_tpu_torch.script.compile import compile_script
    from zang_tpu_torch.script.torch_backend import ScriptInstrument

    with open(os.path.join(ROOT, "zang_tpu_torch", "data", "demo_synth.txt")) as f:
        cs = compile_script(f.read())
    make = lambda: [(ScriptInstrument(cs, "DemoSynth"), 2)]  # noqa: E731
    fleet = LiveFleet(make, 2, SR, block_size=BLOCK, device="cpu")
    singles = [LiveSession(make(), SR, BLOCK, device="cpu") for _ in range(2)]
    streams = [_key_stream(40 + lane, 6) for lane in range(2)]
    outs, refs = [], [[], []]
    for b in range(6):
        for lane in range(2):
            for k, down in streams[lane][b]:
                fleet.key_event(lane, 0, k, down)
                singles[lane].key_event(0, k, down)
        outs.append(fleet.render_block())
        for lane in range(2):
            refs[lane].append(singles[lane].render_block())
    got = np.concatenate(outs, axis=2)
    for lane in range(2):
        assert np.abs(got[lane] - np.concatenate(refs[lane], axis=1)).max() <= TOL_LANES
    assert np.abs(got).max() > 0.01


def test_param_on_one_lane_leaves_the_other_bit_equal():
    make = lambda: [(ti.FMSynthInstrument(), 2)]  # noqa: E731
    changed = LiveFleet(make, 2, SR, block_size=BLOCK, device="cpu")
    plain = LiveFleet(make, 2, SR, block_size=BLOCK, device="cpu")
    outs = {id(changed): [], id(plain): []}
    for b, keys in enumerate(_key_stream(5, 6)):
        for fl in (changed, plain):
            for lane in range(2):
                for k, down in keys:
                    fl.key_event(lane, 0, k, down)
        if b == 2:
            changed.set_param(1, 0, "mod_waveform", 3)
            changed.set_param(1, 0, "mod_feedback", 1)
        for fl in (changed, plain):
            outs[id(fl)].append(fl.render_block())
    a = np.concatenate(outs[id(changed)], axis=2)
    b = np.concatenate(outs[id(plain)], axis=2)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[1], b[1])


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_plain_svf_router_called_once_a_block(lanes, monkeypatch):
    """Lanes fold into the voice axis: one dense-cut SVF call a part and
    block (K2 on the card), whatever the lane count."""
    calls = []
    ref = filters.svf_filter_ref

    def counting(*a, **k):
        calls.append(a[2].shape)
        return ref(*a, **k)

    monkeypatch.setattr(filters, "svf_filter_ref", counting)
    fleet = LiveFleet(lambda: [(ti.NiceInstrument(0.3), 4)], lanes, SR, block_size=BLOCK,
                      device="cpu")
    for lane in range(lanes):
        fleet.key_event(lane, 0, KEYS[lane], True)
    for _ in range(3):
        calls.clear()
        fleet.render_block()
        assert calls == [(4 * lanes, BLOCK)]


def test_fmsynth_fleet_waveform_a_lane_matches_jax():
    """Two FMSynth lanes with different mod_waveform (the kernel takes a
    waveform a voice): the port's fleet against the JAX fleet."""
    fleets = [F(lambda m=m: [(m.FMSynthInstrument(), 2)], 2, SR, block_size=BLOCK, **kw)
              for F, m, kw in ((LiveFleet, ti, {"device": "cpu"}), (JLiveFleet, ji, {}))]
    for fl in fleets:
        fl.set_param(1, 0, "mod_waveform", 2)
        fl.set_param(0, 0, "mod_waveform", 1)
    outs = [[], []]
    for b, keys in enumerate(_key_stream(9, 8)):
        for fl, out in zip(fleets, outs):
            for lane in range(2):
                for k, down in keys:
                    fl.key_event(lane, 0, k, down)
            out.append(np.asarray(fl.render_block()))
    got, want = (np.concatenate(o, axis=2) for o in outs)
    assert np.abs(want).max() > 0.01
    assert not np.allclose(got[0], got[1])
    assert _rms_db(got, want) < TOL_DB


def test_fleet_lane_management():
    """attach (growth), detach (silence, slot reused), reset, and a lane's
    snapshot restored onto another fleet continue bit for bit."""
    make = lambda: [(ti.NiceInstrument(0.3), 2)]  # noqa: E731
    fleet = LiveFleet(make, 1, SR, block_size=BLOCK, device="cpu")
    fleet.key_event(0, 0, "z", True)
    fleet.render_block()
    assert fleet.attach_lane() == 1 and fleet.num_lanes == 2
    fleet.key_event(1, 0, "x", True)
    fleet.render_block()
    blob = fleet.snapshot_lane(1)
    other = LiveFleet(make, 2, SR, block_size=BLOCK, device="cpu")
    other.restore_lane(0, blob)
    np.testing.assert_array_equal(other.render_blocks(3)[0], fleet.render_blocks(3)[1])
    fleet.detach_lane(1)
    with pytest.raises(ValueError, match="detached"):
        fleet.key_event(1, 0, "z", True)
    assert np.abs(fleet.render_block()[1]).max() == 0.0
    assert fleet.attach_lane() == 1
    fleet.reset_lane(0)
    assert np.abs(fleet.render_block()).max() == 0.0


def test_fleet_pcm16_and_warmup():
    fleet = LiveFleet(lambda: [(ti.NiceInstrument(0.3), 2)], 2, SR, block_size=BLOCK,
                      pcm16_volume=0.5, device="cpu")
    f32 = LiveFleet(lambda: [(ti.NiceInstrument(0.3), 2)], 2, SR, block_size=BLOCK,
                    device="cpu")
    fleet.warmup([2, 4])
    for fl in (fleet, f32):
        fl.key_event(0, 0, "z", True)
    a, b = fleet.render_block(), f32.render_block()
    assert a.dtype == np.int16
    np.testing.assert_array_equal(a, mixdown_s16_np(b, 0.5))


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (LiveSession.__init__, LiveFleet.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    import torch

    if not torch.cuda.is_available():
        for make in (lambda: LiveSession([(ti.NiceInstrument(0.3), 2)], SR),
                     lambda: LiveFleet(lambda: [(ti.NiceInstrument(0.3), 2)], 2, SR),
                     lambda: MultiInstrumentServer(builtin_instruments(SR, 2), port=0)):
            with pytest.raises(RuntimeError, match="cuda"):
                make()


# -- the TCP server --------------------------------------------------------------


def _read_until_audible(c, max_blocks=400):
    for _ in range(max_blocks):
        if float(np.abs(c.read_block()).max()) > 100:
            return True
    raise AssertionError(f"no audible block within {max_blocks}")


def _server(make=lambda: [(ti.NiceInstrument(0.3), 2)], **kw):
    kw.setdefault("initial_lanes", 2)
    kw.setdefault("realtime", False)
    kw.setdefault("block_size", BLOCK)
    return LiveServer(make, SR, port=0, device="cpu", **kw)


def _client(srv, **kw):
    c = LiveClient(srv.host, srv.port, timeout=DEADLINE, **kw)
    return c


def test_server_protocol():
    with _server() as srv:
        c = _client(srv)
        try:
            w = c.welcome
            assert (w["op"], w["sample_rate"], w["block_size"], w["dtype"],
                    w["num_channels"], w["num_parts"]) == ("welcome", SR, BLOCK, "int16", 1, 1)
            assert len(w["resume_token"]) == 32
            c.send_event(0, {"freq": 440.0, "note_on": True})
            assert _read_until_audible(c)
            c.send_key(0, "x", True)
            st = c.stats()
            assert st["clients"] == 1 and st["lanes"] == 2 and st["dtype"] == "int16"
            assert st["blocks_served"] > 0
            _send_raw(c, {"op": "nope"})
            with pytest.raises(RuntimeError, match="unknown op"):
                c.read_control()
            assert c.read_block().shape == (1, BLOCK)  # the lane lives on
        finally:
            c.close()


def _send_raw(c, obj):
    import json

    c.sock.sendall(json.dumps(obj).encode() + b"\n")


def test_server_live_parameters():
    with _server(lambda: [(ti.FMSynthInstrument(), 2)]) as srv:
        c = _client(srv)
        try:
            p = c.params(0)
            assert [s["name"] for s in p["specs"]][:3] == ["mod_freq_mul", "mod_waveform",
                                                            "mod_volume"]
            assert c.set_param(0, "mod_waveform", 9) == 3  # clamped
            assert c.step_param(0, "mod_waveform", -1) == 2
            vals = c.randomize_params(0, seed=3)
            assert set(vals) == {s["name"] for s in p["specs"]}
            with pytest.raises(RuntimeError, match="part 5 out of range"):
                c.set_param(5, "mod_waveform", 1)
        finally:
            c.close()


def test_server_resume_and_migration():
    """An unplanned disconnect keeps the session under its resume token; a
    snapshot taken on one server restores on another."""
    with _server(allow_migration=True) as srv:
        c = _client(srv)
        c.send_event(0, {"freq": 330.0, "note_on": True}, note_id=7)
        assert _read_until_audible(c)
        blob = c.snapshot()
        token = c.welcome["resume_token"]
        c.sock.shutdown(socket.SHUT_RDWR)
        c.sock.close()  # no bye
        c2 = _client(srv)
        try:
            deadline = time.monotonic() + DEADLINE
            while True:
                try:
                    frame = c2.resume(token)
                    break
                except RuntimeError:
                    assert time.monotonic() < deadline, "the session was never retained"
                    time.sleep(0.05)
            assert frame > 0
            with pytest.raises(RuntimeError, match="unknown or expired"):
                c2.resume(token)  # single use
        finally:
            c2.close()
        with _server(allow_migration=True) as other:
            c3 = _client(other)
            try:
                assert c3.restore(blob) > 0
                assert _read_until_audible(c3)
            finally:
                c3.close()
        with _server(lambda: [(ti.PMOscInstrument(1.0), 2)], allow_migration=True) as third:
            c4 = _client(third)
            try:
                with pytest.raises(RuntimeError, match="restore failed"):
                    c4.restore(blob)
            finally:
                c4.close()


def test_multi_instrument_routing():
    menu = builtin_instruments(SR, 2)
    with MultiInstrumentServer(menu, port=0, default_instrument="nice", initial_lanes=1,
                               block_size=BLOCK, realtime=False, device="cpu") as srv:
        got = list_instruments(srv.host, srv.port)
        assert got["available"] == sorted(menu) and got["default"] == "nice"
        a = LiveClient(srv.host, srv.port, timeout=DEADLINE, instrument="pmosc")
        b = LiveClient(srv.host, srv.port, timeout=DEADLINE)
        try:
            assert a.welcome["instrument"] == "pmosc" and b.welcome["instrument"] == "nice"
            a.send_key(0, "z", True)
            b.send_key(0, "x", True)
            assert _read_until_audible(a) and _read_until_audible(b)
            assert sorted(srv.stats()["instruments"]) == ["nice", "pmosc"]
            with pytest.raises(RuntimeError, match="unknown instrument"):
                LiveClient(srv.host, srv.port, timeout=DEADLINE, instrument="nope")
        finally:
            a.close()
            b.close()


def test_replay_live_toccata():
    """replay_live of toccata.mid's first seconds at a high rate into a
    lane: the lane drains the events and plays; its stream is the session
    fed the same events (captured as they were sent) mixed down."""
    with open(os.path.join(ROOT, "zang_tpu_torch", "data", "toccata.mid"), "rb") as f:
        data = f.read()
    with _server(lambda: [(ti.NiceInstrument(0.3), 4)]) as srv:
        c = _client(srv)
        try:
            sent = []

            class Capped:
                welcome = c.welcome

                @staticmethod
                def send_event(part, params, note_id=None):
                    if len(sent) == 40:
                        raise StopIteration
                    sent.append((part, params, note_id))
                    c.send_event(part, params, note_id=note_id)

            with pytest.raises(StopIteration):
                midi.replay_live(data, Capped, rate=50.0)
            assert len(sent) == 40 and all(p == 0 for p, _, _ in sent)
            assert _read_until_audible(c)
        finally:
            c.close()


def test_midi_cli_live_needs_no_output(tmp_path):
    with pytest.raises(SystemExit):
        midi.main([os.path.join(ROOT, "zang_tpu_torch", "data", "toccata.mid")])


# -- the copies -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["keyboard", "params", "interaction"])
def test_host_copies_are_the_originals(name):
    """Line for line, but the docstring line that names the original."""
    def body(path):
        with open(path) as f:
            lines = f.read().splitlines()
        return [ln for ln in lines if not ln.startswith("A copy of zang_tpu/")]

    port = body(os.path.join(ROOT, "zang_tpu_torch", "host", f"{name}.py"))
    orig = body(os.path.join(ROOT, "zang_tpu", "host", f"{name}.py"))
    assert [ln for ln in port if ln] == [ln for ln in orig if ln]
