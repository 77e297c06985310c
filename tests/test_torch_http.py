"""The port's HTTP render tier (zang_tpu_torch/serve/http.py) against
zang_tpu's (tests/test_serve_http.py), each server on localhost port 0 and
on the CPU.

- Every request validation case of tests/test_serve_http.py, and the other
  bounds of the JAX server, returns the JAX server's status code and JSON
  error text, word for word (a zangscript error's caret diagnostics too).
- Served PCM within 1 LSB of the JAX server's response to the same
  request (the s16 budget: the f32 renders agree below -90 dBFS, so a
  sample on a rounding edge may fall one step apart): an example, a script,
  a MIDI file, the stream and each job of a batch fetched back from its
  /v1/result URL. The port's own responses are its renders mixed down, bit
  for bit.
- Single flight, the caches and the stats counters move as the JAX
  server's do for the same requests; a stream whose first step fails is a
  clean 500, and the stream holds a render slot only while it renders.
- devices: the server renders on the card unless made with device="cpu",
  and raises without CUDA.
"""

import base64
import json
import os
import struct
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from zang_tpu.serve.http import RenderHTTPServer as JServer
from zang_tpu_torch.core.mixdown import mixdown_s16_np
from zang_tpu_torch.serve.http import RenderHTTPServer as TServer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_midi import note_off, note_on, smf, tempo  # noqa: E402

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

LSB = 1  # served PCM, port against JAX
TEST_SCRIPT = """
TestSynth = defmodule freq: cob, note_on: boolean, begin
    e = Envelope(attack=.cubed(0.01), decay=.cubed(0.05), release=.cubed(0.1),
                 sustain_volume=0.8, note_on)
    out SineOsc(freq, phase=0) * e * 0.5
end
"""


@pytest.fixture(scope="module")
def servers():
    with JServer(max_seconds=5.0) as j, TServer(max_seconds=5.0, device="cpu") as t:
        yield j, t


def _request(srv, method, path, body=None, raw=None, timeout=300.0):
    """(status, headers, bytes) of one request; errors are answers too."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _pcm(data: bytes):
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", data[:12]
    sr = struct.unpack_from("<I", data, 24)[0]
    ch = struct.unpack_from("<H", data, 22)[0]
    n = struct.unpack_from("<I", data, 40)[0]
    return sr, ch, np.frombuffer(data[44:44 + n], dtype=np.int16)


def _midi(tracks):
    return base64.b64encode(smf(tracks)).decode()


TWO_NOTES = [tempo(0, 400000), note_on(0, 69) + note_off(480, 69)
             + note_on(0, 72) + note_off(480, 72)]
WHOLE = smf([note_on(0, 60)])

# (method, path, JSON body or raw bytes) -> the JAX server's status and text
CASES = {
    # tests/test_serve_http.py
    "unknown example": ("GET", "/v1/render?example=nope", None),
    "missing example": ("GET", "/v1/render", None),
    "seconds over cap": ("GET", "/v1/render?example=envelope&seconds=3600", None),
    "unknown endpoint": ("GET", "/v1/nope", None),
    "script body not JSON": ("POST", "/v1/render/script", b"not json"),
    "script compile error": ("POST", "/v1/render/script",
                             {"script": "Broken = defmodule begin out NoSuchThing() end",
                              "seconds": 0.5}),
    "midi bad base64": ("POST", "/v1/render/midi", {"midi_base64": "not base64!"}),
    "midi not a MIDI file": ("POST", "/v1/render/midi",
                             {"midi_base64": base64.b64encode(b"RIFFnope").decode()}),
    "midi script path": ("POST", "/v1/render/midi",
                         {"midi_base64": _midi(TWO_NOTES), "instrument": "/etc/hostname"}),
    "midi part cap": ("POST", "/v1/render/midi",
                      {"midi_base64": _midi([note_on(0, 60 + i % 12) + note_off(10, 60 + i % 12)
                                             for i in range(24)]), "group": "track"}),
    "midi truncated": ("POST", "/v1/render/midi",
                       {"midi_base64": base64.b64encode(
                           WHOLE[:18] + (2).to_bytes(4, "big") + WHOLE[22:24]).decode()}),
    "stream unknown config": ("GET", "/v1/render/stream?config=nope", None),
    "stream seconds over cap": ("GET", "/v1/render/stream?config=sampler&seconds=100000", None),
    "batch no jobs": ("POST", "/v1/render/batch", {"jobs": []}),
    "batch too many jobs": ("POST", "/v1/render/batch", {"jobs": [{"config": "sampler"}] * 99}),
    "batch job without config": ("POST", "/v1/render/batch", {"jobs": [{"what": 1}]}),
    "result miss": ("GET", "/v1/result/deadbeef", None),
    # the other bounds of zang_tpu/serve/http.py
    "volume out of range": ("GET", "/v1/render?example=play&volume=2", None),
    "seconds not a number": ("GET", "/v1/render?example=play&seconds=abc", None),
    "script body not an object": ("POST", "/v1/render/script", [1, 2]),
    "script missing": ("POST", "/v1/render/script", {"seconds": 1.0}),
    "script too large": ("POST", "/v1/render/script", {"script": "x" * 70000}),
    "script polyphony": ("POST", "/v1/render/script", {"script": TEST_SCRIPT, "polyphony": 0}),
    "script sample rate": ("POST", "/v1/render/script",
                           {"script": TEST_SCRIPT, "sample_rate": 0}),
    "script notes": ("POST", "/v1/render/script", {"script": TEST_SCRIPT, "notes": [[1, 2]]}),
    "midi missing base64": ("POST", "/v1/render/midi", {"instrument": "nice"}),
    "midi group": ("POST", "/v1/render/midi", {"midi_base64": _midi(TWO_NOTES), "group": "x"}),
    "midi transpose": ("POST", "/v1/render/midi",
                       {"midi_base64": _midi(TWO_NOTES), "transpose": 200}),
    "midi unknown instrument": ("POST", "/v1/render/midi",
                                {"midi_base64": _midi(TWO_NOTES), "instrument": "nope"}),
    "stream missing config": ("GET", "/v1/render/stream", None),
    "stream seconds not a number": ("GET", "/v1/render/stream?config=song&seconds=x", None),
    "batch body not JSON": ("POST", "/v1/render/batch", b"{"),
    "batch job not an object": ("POST", "/v1/render/batch", {"jobs": [3]}),
    "batch job seconds": ("POST", "/v1/render/batch",
                          {"jobs": [{"config": "song", "seconds": "x"}]}),
    "batch job seconds over cap": ("POST", "/v1/render/batch",
                                   {"jobs": [{"config": "song", "seconds": 1e6}]}),
    "batch unknown config": ("POST", "/v1/render/batch", {"jobs": [{"config": "nope"}]}),
    "batch script polyphony": ("POST", "/v1/render/batch",
                               {"jobs": [{"script": TEST_SCRIPT, "polyphony": 999}]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validation_is_the_jax_servers(servers, case):
    method, path, body = CASES[case]
    raw = body if isinstance(body, bytes) else None
    answers = [_request(srv, method, path, None if raw else body, raw, timeout=120.0)
               for srv in servers]
    (jcode, jhead, jdata), (tcode, thead, tdata) = answers
    assert 400 <= jcode < 500, (case, jcode, jdata)
    assert tcode == jcode, (case, tcode, tdata)
    assert thead["Content-Type"] == jhead["Content-Type"] == "application/json"
    assert json.loads(tdata) == json.loads(jdata), case


def test_menu_is_the_jax_servers(servers):
    menus = [json.loads(_request(srv, "GET", "/v1/examples")[2]) for srv in servers]
    assert menus[1] == menus[0]
    assert "/v1/render/stream" in menus[1]["endpoints"] and "song" in menus[1]["examples"]


# ---------------------------------------------------------------------------
# served PCM: within 1 LSB of the JAX server's; the port's own render's bits


def _both(servers, method, path, body=None):
    out = []
    for srv in servers:
        code, head, data = _request(srv, method, path, body)
        assert code == 200, (srv, data[:300])
        assert head["Content-Type"] == "audio/wav"
        out.append(_pcm(data))
    (jsr, jch, jpcm), (tsr, tch, tpcm) = out
    assert (tsr, tch, tpcm.shape) == (jsr, jch, jpcm.shape)
    assert np.abs(jpcm).max() > 100  # audible
    assert np.abs(tpcm.astype(np.int32) - jpcm.astype(np.int32)).max() <= LSB
    return tsr, tch, tpcm


def test_example_pcm(servers):
    from zang_tpu_torch.host.examples import EXAMPLES

    for name, seconds in (("envelope", 1.0), ("play", 1.0)):
        _, _, pcm = _both(servers, "GET", f"/v1/render?example={name}&seconds={seconds}")
        audio, _ = EXAMPLES[name](seconds=seconds, device="cpu")
        np.testing.assert_array_equal(pcm, mixdown_s16_np(audio.numpy(), 0.25).reshape(-1))


def test_script_pcm(servers):
    body = {"script": TEST_SCRIPT, "seconds": 1.2, "volume": 0.4,
            "notes": [[0.1, 0.5, 440.0], [0.7, 0.3, 660.0]]}
    sr, ch, pcm = _both(servers, "POST", "/v1/render/script", body)
    assert sr == 44100 and ch == 1 and len(pcm) == int(44100 * 1.2)


def test_midi_pcm(servers):
    body = {"midi_base64": _midi(TWO_NOTES), "instrument": "nice,filteredsaw"}
    sr, ch, pcm = _both(servers, "POST", "/v1/render/midi", body)
    assert sr == 48000 and ch == 1


def test_stream_pcm(servers):
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host.configs import build_sampler_performance

    code, head, data = _request(servers[1], "GET", "/v1/render/stream?config=sampler&seconds=1")
    assert code == 200 and int(head["Content-Length"]) == len(data)
    _, _, pcm = _both(servers, "GET", "/v1/render/stream?config=sampler&seconds=1")
    perf, total = build_sampler_performance(seconds=1.0)
    want = mixdown_s16_np(render_performance(perf, total, 65536, device="cpu").numpy(), 0.25)
    np.testing.assert_array_equal(pcm, want.reshape(-1))
    assert _pcm(data)[2].tobytes() == pcm.tobytes()


def test_batch_pcm(servers):
    body = {"jobs": [
        {"name": "drum", "config": "sampler", "seconds": 1.0},
        {"name": "organ", "config": "song", "seconds": 0.5},
        {"name": "synth", "script": TEST_SCRIPT, "seconds": 1.5,
         "notes": [[0.1, 0.5, 440.0]]},
        {"name": "bad", "script": "Bad = defmodule begin out nope end"},
    ], "volume": 0.3}
    answers = []
    for srv in servers:
        code, _, data = _request(srv, "POST", "/v1/render/batch", body)
        assert code == 200
        answers.append({r["name"]: r for r in json.loads(data)["results"]})
    jres, tres = answers
    assert tres.keys() == jres.keys()
    for name in jres:
        assert tres[name]["status"] == jres[name]["status"], name
        assert tres[name]["seconds"] == jres[name]["seconds"]
    assert tres["bad"]["status"] == "failed" and tres["bad"]["error"] == jres["bad"]["error"]
    for name in ("drum", "organ", "synth"):
        assert tres[name]["status"] == "ok", tres[name]
        pcms = []
        for srv, res in zip(servers, (jres, tres)):
            code, _, data = _request(srv, "GET", res[name]["url"])
            assert code == 200
            pcms.append(_pcm(data)[2])
        assert pcms[1].shape == pcms[0].shape and np.abs(pcms[0]).max() > 100
        assert np.abs(pcms[1].astype(np.int32) - pcms[0].astype(np.int32)).max() <= LSB


# ---------------------------------------------------------------------------
# single flight, caches and counters


def test_single_flight_and_counters_move_as_the_jax_servers(servers):
    deltas = []
    for srv in servers:
        before = srv.stats()
        results = []

        def fetch():
            results.append(_request(srv, "GET", "/v1/render?example=envelope&seconds=0.7")[2])

        ts = [threading.Thread(target=fetch) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(results) == 2 and results[0] == results[1]
        again = _request(srv, "GET", "/v1/render?example=envelope&seconds=0.7")[2]
        assert again == results[0]
        assert _request(srv, "GET", "/v1/render?example=nope")[0] == 404
        stats = json.loads(_request(srv, "GET", "/v1/stats")[2])
        after = srv.stats()
        assert stats == after  # /v1/stats is stats(), its own request counted
        deltas.append({
            "requests": after["requests"] - before["requests"],
            "renders": after["renders"] - before["renders"],
            "failures": after["failures"] - before["failures"],
            "cached": after["cached_entries"] - before["cached_entries"],
            "audio": round(after["audio_seconds_rendered"]
                           - before["audio_seconds_rendered"], 3),
        })
        # the second of two concurrent requests either coalesced (counted
        # there and as the cache hit it then finds) or came after the render
        assert (after["cache_hits"] + after["coalesced"]
                >= before["cache_hits"] + before["coalesced"] + 2)
    assert deltas[1] == deltas[0]
    assert deltas[1]["renders"] == 1 and deltas[1]["requests"] == 5


def test_stream_single_flight_shares_one_step(servers, monkeypatch):
    """Concurrent first requests for the same (config, seconds) plan once
    and share one step."""
    import time

    import zang_tpu_torch.serve.http as http_mod

    srv = servers[1]
    calls = []
    real_build = http_mod._build_config

    def slow_build(name, seconds):
        calls.append(name)
        time.sleep(0.3)  # force the second thread into the wait path
        return real_build(name, seconds)

    monkeypatch.setattr(http_mod, "_build_config", slow_build)
    before = srv.stats()["coalesced"]
    results = []

    def fetch():
        results.append(_request(srv, "GET", "/v1/render/stream?config=sampler&seconds=1.21"))

    ts = [threading.Thread(target=fetch) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert calls == ["sampler"]
    assert [r[0] for r in results] == [200, 200] and results[0][2] == results[1][2]
    assert srv.stats()["coalesced"] == before + 1


def test_stream_failure_before_headers_is_clean_error(servers, monkeypatch):
    """The first chunk renders before the headers go out (the kernels
    build and a launch error surfaces there): a failing first step answers
    a JSON 500, never a truncated 200 WAV."""
    import zang_tpu_torch.graph.render as gr

    def broken_step_factory(perf, chunk_size=65536, *, device="cuda"):
        def step(state, c0, xs_chunk, programs=None):
            raise RuntimeError("induced device failure")

        return step

    monkeypatch.setattr(gr, "make_stream_step", broken_step_factory)
    srv = servers[1]
    failures = srv.stats()["failures"]
    code, head, data = _request(srv, "GET", "/v1/render/stream?config=sampler&seconds=1.53")
    assert code == 500 and head["Content-Type"] == "application/json"
    assert json.loads(data) == {"error": "RuntimeError: induced device failure"}
    assert srv.stats()["failures"] == failures + 1


def test_stream_releases_render_slot_during_body_writes(servers):
    srv = servers[1]
    sem_values = []

    class _Wfile:
        @staticmethod
        def write(data):
            sem_values.append(srv._render_sem._value)

        @staticmethod
        def flush():
            pass

    class _FakeHandler:
        wfile = _Wfile()

        def send_response(self, code):
            sem_values.append(("headers", srv._render_sem._value))

        def send_header(self, *a):
            pass

        def end_headers(self):
            pass

    srv._handle_stream(_FakeHandler(), {"config": ["sampler"], "seconds": ["1"]})
    writes = [v for v in sem_values if not isinstance(v, tuple)]
    assert writes and all(v == srv._render_sem._value for v in writes)
    assert min(writes) == max(writes) >= 2


def test_the_server_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TServer()
    with TServer(device="cpu") as srv:
        assert srv.device == torch.device("cpu")
