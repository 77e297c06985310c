"""The port's several-device paths (zang_tpu_torch/parallel/mesh.py and
LiveFleet's mesh argument) against the port's own one-device renders and
the JAX package's sharded ones, one for one with tests/test_parallel.py and
tests/test_serve_live.py's TestFleetSharded.

The sharded render runs one process a device: here 4 CPU processes joined
by gloo, spawned once for all of this file's W = 4 renders (a module
fixture), once more at W = 1. Bounds:

- W = 4 against the one-device render: below -120 dBFS RMS, the JAX test's
  bound for the reordered voice sum (tests/test_parallel.py:45-47);
- against the JAX package's sharded render: the song below -120 dBFS, the
  poly_echo render below -110 dBFS (the port's bound for it,
  tests/test_torch_echo.py:105);
- W = 1, and the ranks against each other: bit for bit;
- the lane-sharded fleet against the one-device fleet within 1e-6
  (tests/test_serve_live.py:120), against the JAX fleet on its 8-device
  mesh below -110 dBFS (tests/test_torch_serve.py's TOL_DB); a lane's
  snapshot restored onto another sharded fleet bit for bit.

The `cuda`-marked cases (NCCL at W = 1, two gloo ranks on one card) skip
without a card.
"""

import functools
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from zang_tpu.core.timeline import SubvoiceTimeline as JTimeline
from zang_tpu.core.timeline import compile_timelines as jcompile_timelines
from zang_tpu.graph.render import Performance as JPerformance
from zang_tpu.host import configs as jconfigs
from zang_tpu.host import instruments as ji
from zang_tpu.host import song as jsong
from zang_tpu.parallel import mesh as jmesh
from zang_tpu.serve.live import LiveFleet as JLiveFleet
from zang_tpu_torch.core.timeline import SubvoiceTimeline
from zang_tpu_torch.graph.render import Performance, render_performance
from zang_tpu_torch.host import configs, song
from zang_tpu_torch.host import instruments as ti
from zang_tpu_torch.host.live import LiveSession
from zang_tpu_torch.parallel import mesh as pm
from zang_tpu_torch.serve.live import LiveFleet

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

W = 4
SONG_TOTAL = int(2.0 * song.SAMPLE_RATE)
SONG_CHUNK = 16384
POLY = dict(num_voices=16, seconds=1.5, sample_rate=44100.0, main_delay=15000)
POLY_TOTAL = int(POLY["seconds"] * POLY["sample_rate"])
POLY_CHUNK = 8192
TOL_SHARD_DB = -120.0
TOL_JAX_POLY_DB = -110.0
TOL_LANES = 1e-6
TOL_LIVE_DB = -110.0
SR = 48000.0
BLOCK = 1024
TIMEOUT = 600.0  # seconds a spawned launch may take

# name -> (build, total frames, chunk); each build padded to a multiple of W
JOBS = {
    "song_three_parts": (functools.partial(song.song_build, SONG_TOTAL, W, True),
                         SONG_TOTAL, SONG_CHUNK),
    "song_merged": (functools.partial(song.song_build, SONG_TOTAL, W), SONG_TOTAL,
                    SONG_CHUNK),
    "poly_echo": (functools.partial(configs.poly_echo_build, multiple=W, **POLY),
                  POLY_TOTAL, POLY_CHUNK),
}


def _db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d * d).mean()) + 1e-30)


def _launch(world, tmp_path):
    """Every job at `world` CPU ranks in one launch: ({name: mix}, {name:
    [each rank's stats]})."""
    jobs = [pm.RenderJob(build, total, chunk, str(tmp_path / f"{name}.npy"))
            for name, (build, total, chunk) in JOBS.items()]
    stats = pm.run_ranks(pm.render_rank, pm.make_mesh(world, device="cpu"), jobs,
                         timeout=TIMEOUT, num_threads=1)
    mixes = {name: np.load(tmp_path / f"{name}.npy") for name in JOBS}
    return mixes, {name: [r[i] for r in stats] for i, name in enumerate(JOBS)}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return _launch(W, tmp_path_factory.mktemp("w4"))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _launch(1, tmp_path_factory.mktemp("w1"))


def _unsharded(name):
    """The port's one-device render of a job, unpadded."""
    if name == "poly_echo":
        parts, sr, kw = configs.poly_echo_build(**POLY)
        return render_performance(Performance(parts, sr, **kw), POLY_TOTAL, POLY_CHUNK,
                                  device="cpu").numpy()
    parts = song.song_parts(SONG_TOTAL, three_part=name == "song_three_parts")
    return render_performance(Performance(parts, song.SAMPLE_RATE), SONG_TOTAL, SONG_CHUNK,
                              device="cpu").numpy()


@pytest.fixture(scope="module")
def unsharded():
    return {name: _unsharded(name) for name in JOBS}


def _jax_song_perf(padded):
    """tests/test_parallel.py:27-38's three-part song, padded to W."""
    sr = jsong.SAMPLE_RATE
    tls = [jcompile_timelines(s, jsong.POLYPHONY[i], sr, SONG_TOTAL)
           for i, s in enumerate(jsong.load_song())]
    if padded:
        tls = [jmesh.pad_timelines(t, W) for t in tls]
    return JPerformance([(ji.PMOscInstrument(0.4, freq_fn=jsong.pedal_freq), tls[0]),
                         (ji.NiceInstrument(0.25), tls[1]),
                         (ji.NiceInstrument(0.1), tls[2])], sr)


# -- the voice-sharded render ---------------------------------------------------


def test_sharded_equals_unsharded(sharded, unsharded):
    """tests/test_parallel.py:19: the three-part song at W = 4 against the
    port's one-device render and the JAX package's sharded render on
    make_mesh(4) of the virtual CPU devices."""
    got = sharded[0]["song_three_parts"]
    assert got.shape == (1, SONG_TOTAL) and got.dtype == np.float32
    assert np.abs(got).max() > 0.1
    assert _db(got, unsharded["song_three_parts"]) < TOL_SHARD_DB
    want = jmesh.render_performance_sharded(_jax_song_perf(True), SONG_TOTAL,
                                            jmesh.make_mesh(W), chunk_size=SONG_CHUNK)
    assert _db(got, want) < TOL_SHARD_DB


def test_merged_song_sharded_equals_unsharded(sharded, unsharded):
    """The song's merged organ (a color a voice, 14 voices padded to 16):
    each rank renders its 4 voices with their own colors."""
    got = sharded[0]["song_merged"]
    assert np.abs(got).max() > 0.1
    assert _db(got, unsharded["song_merged"]) < TOL_SHARD_DB
    assert [s["voices"] for s in sharded[1]["song_merged"]] == [[1, 4]] * W


def test_poly_echo_sharded_equals_unsharded(sharded, unsharded):
    """tests/test_parallel.py:129: the post chain runs once on the summed
    mix, with the whole piece's 1/16 scale."""
    got = sharded[0]["poly_echo"]
    assert got.shape == (2, POLY_TOTAL)
    assert np.abs(got).max() > 0.01
    for ch in range(2):
        assert _db(got[ch], unsharded["poly_echo"][ch]) < TOL_SHARD_DB
    jperf, jtotal = jconfigs.build_poly_echo_performance(**POLY)
    want = jmesh.render_performance_sharded(jperf, jtotal, jmesh.make_mesh(W),
                                            chunk_size=POLY_CHUNK)
    for ch in range(2):
        assert _db(got[ch], want[ch]) < TOL_JAX_POLY_DB


@pytest.mark.parametrize("name", list(JOBS))
def test_one_rank_is_render_performance(one_rank, unsharded, name):
    """At W = 1 the all-reduce is the identity: render_performance's bits."""
    np.testing.assert_array_equal(one_rank[0][name], unsharded[name])


@pytest.mark.parametrize("name", list(JOBS))
def test_ranks_agree_bit_for_bit(sharded, name):
    stats = sharded[1][name]
    assert [s["rank"] for s in stats] == list(range(W))
    assert len({s["digest"] for s in stats}) == 1
    assert all(s["launches"] == dict.fromkeys(s["launches"], 0) for s in stats)  # the CPU


def test_pad_timelines_matches_jax():
    tls = song.song_parts(SONG_TOTAL)[1][1]
    jtls = [JTimeline(t.starts, t.resets, t.params, t.total) for t in tls]
    got, want = pm.pad_timelines(tls, 8), jmesh.pad_timelines(jtls, 8)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert isinstance(g, SubvoiceTimeline)
        np.testing.assert_array_equal(g.starts, w.starts)
        assert g.starts.dtype == w.starts.dtype
        np.testing.assert_array_equal(g.resets, w.resets)
        assert g.resets.dtype == w.resets.dtype
        assert g.params == w.params and g.total == w.total


def test_shard_parts_cuts_the_organ_colors():
    parts = song.song_parts(SONG_TOTAL, multiple=4)
    organ = parts[1][0]
    assert organ.color.shape == (16,) and organ.color[-1] == np.float32(0.1)
    slices = [pm.shard_parts(parts, r, 4) for r in range(4)]
    assert [s[0][0] for s in slices] == [parts[0][0]] * 4  # the pedal is shared
    np.testing.assert_array_equal(np.concatenate([s[1][0].color for s in slices]),
                                  organ.color)
    assert all(len(s[1][1]) == 4 for s in slices)
    # a color array shorter than the part is padded with its last color
    short = [(ti.NiceInstrument(np.array([0.25, 0.1], np.float32)), parts[1][1][:4])]
    np.testing.assert_array_equal(pm.shard_parts(short, 1, 2)[0][0].color,
                                  np.float32([0.1, 0.1]))


def test_shard_parts_refuses_what_it_cannot_cut():
    parts = song.song_parts(SONG_TOTAL)  # 3 and 14 voices
    with pytest.raises(ValueError, match="pad_timelines"):
        pm.shard_parts(parts, 0, 4)
    odd = ti.PMOscInstrument(0.4)
    odd.gains = np.ones(4, np.float32)  # an array the slice does not know
    with pytest.raises(ValueError, match="gains"):
        pm.shard_parts([(odd, parts[1][1][:4])], 0, 2)


def _fail_on_rank_one(rank):
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if rank.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


def test_a_rank_that_raises_fails_the_call():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        pm.run_ranks(_fail_on_rank_one, pm.make_mesh(2, device="cpu"), timeout=TIMEOUT,
                     num_threads=1)
    assert time.monotonic() - t < 120.0


def test_a_voice_count_not_a_multiple_fails_the_render():
    build = functools.partial(song.song_build, SONG_TOTAL, 1, True)  # 3, 10, 4 voices
    with pytest.raises(RuntimeError, match="pad_timelines"):
        pm.render_performance_sharded(build, SONG_TOTAL, pm.make_mesh(4, device="cpu"),
                                      SONG_CHUNK, timeout=TIMEOUT)


@pytest.mark.parametrize("kw, devices, backend", [
    (dict(n_devices=4, device="cpu"), ["cpu"] * 4, "gloo"),
    (dict(device="cpu"), ["cpu"], "gloo"),
    (dict(devices=["cpu", "cpu"]), ["cpu"] * 2, "gloo"),
    (dict(n_devices=2, device="cpu", axis="lanes"), ["cpu"] * 2, "gloo"),
])
def test_make_mesh(kw, devices, backend):
    mesh = pm.make_mesh(**kw)
    assert [str(d) for d in mesh.devices] == devices and mesh.backend == backend
    assert mesh.size == len(devices) and mesh.axis == kw.get("axis", "voices")


@pytest.mark.parametrize("kw, err", [
    (dict(n_devices=2, device="cpu", backend="nccl"), ValueError),
    (dict(n_devices=2, device="cpu", backend="mpi"), ValueError),
    (dict(n_devices=2, device="cpu", axis="time"), ValueError),
    (dict(n_devices=3, devices=["cpu", "cpu"]), ValueError),
])
def test_make_mesh_refuses(kw, err):
    with pytest.raises(err):
        pm.make_mesh(**kw)


def test_make_mesh_defaults_to_the_card(monkeypatch):
    import inspect

    assert inspect.signature(pm.make_mesh).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pm.make_mesh(2)


def test_make_mesh_never_shrinks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 cards asked for, 1 present"):
        pm.make_mesh(2)
    mesh = pm.make_mesh(1)
    assert mesh.devices == (torch.device("cuda", 0),) and mesh.backend == "nccl"
    two = pm.make_mesh(devices=["cuda:0", "cuda:0"])
    assert two.backend == "gloo"
    with pytest.raises(ValueError, match="distinct"):
        pm.make_mesh(devices=["cuda:0", "cuda:0"], backend="nccl")


# -- the lane-sharded fleet -----------------------------------------------------


def _events(seed, n_notes=6):
    """tests/test_serve_live.py:15's note stream: {block: [(params, id)]}."""
    rng = np.random.default_rng(seed)
    by_block = {}
    for i in range(n_notes):
        f = float(np.float32(220.0 * 2 ** (rng.integers(0, 13) / 12.0)))
        by_block.setdefault(i, []).append(({"freq": f, "note_on": True}, i + 1))
        by_block.setdefault(i + 1, []).append(({"freq": f, "note_on": False}, i + 1))
    return by_block


def _drive(push, by_block, blk, lane=None):
    for params, nid in by_block.get(blk, []):
        if lane is None:
            push(0, params, note_id=nid)
        else:
            push(lane, 0, params, note_id=nid)


def _lane_mesh(n):
    return pm.make_mesh(n, device="cpu", axis="lanes")


def _nice(m=ti):
    return lambda: [(m.NiceInstrument(0.3), 2)]


def test_lane_sharded_matches_unsharded():
    """tests/test_serve_live.py:98: 8 lanes over 8 CPU entries, a group
    each, against the one-device fleet, block for block."""
    sharded = LiveFleet(_nice(), 8, SR, block_size=BLOCK, device="cpu", mesh=_lane_mesh(8))
    plain = LiveFleet(_nice(), 8, SR, block_size=BLOCK, device="cpu")
    streams = [_events(10 + lane) for lane in range(8)]
    outs_s, outs_p = [], []
    for blk in range(6):
        for lane, bb in enumerate(streams):
            _drive(sharded.push_event, bb, blk, lane=lane)
            _drive(plain.push_event, bb, blk, lane=lane)
        outs_s.append(sharded.render_block())
        outs_p.append(plain.render_block())
    a, b = np.concatenate(outs_s, axis=2), np.concatenate(outs_p, axis=2)
    assert a.shape == (8, 1, 6 * BLOCK)
    assert np.abs(a - b).max() < TOL_LANES
    assert np.abs(a).max() > 0.01


def test_lane_count_must_divide_mesh():
    with pytest.raises(ValueError, match="multiple of the mesh"):
        LiveFleet(_nice(), 6, SR, block_size=BLOCK, device="cpu", mesh=_lane_mesh(8))


def test_attach_grows_in_multiples_of_the_mesh():
    """zang_tpu/serve/live.py:141-146: 2 lanes on 2 entries grow to 4 and 8;
    lanes that change group keep their sessions' bits."""
    fleet = LiveFleet(_nice(), 2, SR, block_size=BLOCK, device="cpu", mesh=_lane_mesh(2))
    singles = [LiveSession(_nice()(), SR, BLOCK, device="cpu") for _ in range(2)]
    streams = [_events(3), _events(4)]
    outs, refs = [], [[], []]
    for blk in range(6):
        for lane, bb in enumerate(streams):
            _drive(fleet.push_event, bb, blk, lane=lane)
            _drive(singles[lane].push_event, bb, blk)
        if blk == 2:  # 2 -> 4 lanes: lane 1 moves into group 0
            assert fleet.attach_lane() == 2 and fleet.num_lanes == 4
        if blk == 3:  # a free slot first, then 4 -> 8
            assert fleet.attach_lane() == 3 and fleet.num_lanes == 4
            assert fleet.attach_lane() == 4 and fleet.num_lanes == 8
        outs.append(fleet.render_block()[:2])
        for lane in range(2):
            refs[lane].append(singles[lane].render_block())
    got = np.concatenate(outs, axis=2)
    for lane in range(2):
        assert np.abs(got[lane] - np.concatenate(refs[lane], axis=1)).max() < TOL_LANES
    assert np.abs(got).max() > 0.01
    assert sorted(fleet.active_lanes) == [0, 1, 2, 3, 4]


def test_sharded_snapshot_restore_bit_exact():
    """__graft_entry__.py:120-134: a lane's slice of the sharded state
    restored into a second sharded fleet continues bit for bit."""
    mesh = _lane_mesh(8)
    fleet = LiveFleet(_nice(), 8, SR, block_size=512, device="cpu", mesh=mesh)
    for lane in range(8):
        fleet.push_event(lane, 0, {"freq": 220.0 + 55.0 * lane, "note_on": True})
    out = fleet.render_block()
    assert out.shape == (8, 1, 512) and np.abs(out).max() > 1e-4
    blob = fleet.snapshot_lane(1)
    ref = fleet.render_block()[1]
    other = LiveFleet(_nice(), 8, SR, block_size=512, device="cpu", mesh=mesh)
    other.restore_lane(0, blob)
    np.testing.assert_array_equal(other.render_block()[0], ref)
    fleet.reset_lane(1)  # a reset lane in another group than 0 starts silent
    assert np.abs(fleet.render_block()[1]).max() == 0.0


def test_sharded_fleet_matches_jax():
    """The port's fleet on 8 CPU entries against the JAX fleet on its
    8-device mesh, at the port's live bound."""
    jfleet = JLiveFleet(_nice(ji), 8, SR, block_size=BLOCK,
                        mesh=JMesh(np.array(jax.devices()[:8]), ("lanes",)))
    tfleet = LiveFleet(_nice(), 8, SR, block_size=BLOCK, device="cpu", mesh=_lane_mesh(8))
    streams = [_events(30 + lane) for lane in range(8)]
    outs = [[], []]
    for blk in range(6):
        for fl, out in zip((tfleet, jfleet), outs):
            for lane, bb in enumerate(streams):
                _drive(fl.push_event, bb, blk, lane=lane)
            out.append(np.asarray(fl.render_block()))
    got, want = (np.concatenate(o, axis=2) for o in outs)
    assert np.abs(want).max() > 0.01
    assert _db(got, want) < TOL_LIVE_DB


def test_fleet_warmup_over_the_mesh():
    fleet = LiveFleet(_nice(), 2, SR, block_size=BLOCK, device="cpu", mesh=_lane_mesh(2),
                      pcm16_volume=0.5)
    fleet.warmup([2, 4])
    fleet.push_event(1, 0, {"freq": 330.0, "note_on": True})
    out = fleet.render_block()
    assert out.dtype == np.int16 and out.shape == (2, 1, BLOCK)
    assert np.abs(out[0]).max() == 0 and np.abs(out[1]).max() > 0


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_nccl_one_rank_is_render_performance(cuda_device):
    """NCCL at W = 1 on cuda:0: the one-card render's bits."""
    build = functools.partial(song.song_build, SONG_TOTAL)
    got = pm.render_performance_sharded(build, SONG_TOTAL, pm.make_mesh(1), SONG_CHUNK,
                                        timeout=TIMEOUT)
    want = render_performance(song.build_performance(SONG_TOTAL), SONG_TOTAL, SONG_CHUNK,
                              device=cuda_device).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    """Two ranks on cuda:0 through gloo: each launches K1 a chunk at its own
    voices, the mix within -120 dBFS of the one-card render."""
    mesh = pm.make_mesh(devices=[cuda_device, cuda_device])
    assert mesh.backend == "gloo"
    job = pm.RenderJob(functools.partial(song.song_build, SONG_TOTAL, 2), SONG_TOTAL,
                       SONG_CHUNK, str(tmp_path / "mix.npy"))
    stats = pm.run_ranks(pm.render_rank, mesh, [job], timeout=TIMEOUT)
    got = np.load(tmp_path / "mix.npy")
    want = render_performance(song.build_performance(SONG_TOTAL), SONG_TOTAL, SONG_CHUNK,
                              device=cuda_device).cpu().numpy()
    assert _db(got, want) < TOL_SHARD_DB
    n_chunks = -(-SONG_TOTAL // SONG_CHUNK)
    assert [s[0]["launches"]["svf_table"] for s in stats] == [n_chunks, n_chunks]
    assert len({s[0]["digest"] for s in stats}) == 1
